from xitorch_tpu_torch.utils.bcast import normalize_bcast_dims, get_bcasted_dims  # noqa: F401
from xitorch_tpu_torch.utils.convergence import assert_converged  # noqa: F401
from xitorch_tpu_torch.utils.exceptions import (  # noqa: F401
    GetSetParamsError, ConvergenceWarning, MathWarning,
)
from xitorch_tpu_torch.utils.misc import get_method  # noqa: F401
from xitorch_tpu_torch.utils.tensor import einsum_hi, dot_hi, ieee_f32, tallqr  # noqa: F401
