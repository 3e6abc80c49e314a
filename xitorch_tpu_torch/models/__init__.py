from xitorch_tpu_torch.models.deq import (  # noqa: F401
    DEQParams, init_deq, deq_forward, deq_loss, train_step,
)
from xitorch_tpu_torch.models.moire import (  # noqa: F401
    bm_hamiltonian, flat_band_loss,
)
from xitorch_tpu_torch.models.node import (  # noqa: F401
    NODEParams, init_node, node_forward, node_loss,
)
from xitorch_tpu_torch.models.scf import HamiltonianOp, scf_density, scf_energy  # noqa: F401
