from xitorch_tpu_torch.linalg.solve import flush_convergence_warnings, solve  # noqa: F401
from xitorch_tpu_torch.linalg.symeig import lsymeig, svd, symeig, usymeig  # noqa: F401
