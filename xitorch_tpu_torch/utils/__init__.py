from xitorch_tpu_torch.utils.bcast import (  # noqa: F401
    normalize_bcast_dims, get_bcasted_dims, match_dim,
)
from xitorch_tpu_torch.utils.convergence import assert_converged  # noqa: F401
from xitorch_tpu_torch.utils.exceptions import (  # noqa: F401
    GetSetParamsError, ConvergenceWarning, MathWarning,
)
from xitorch_tpu_torch.utils.misc import (  # noqa: F401
    set_default_option, get_and_pop_keys, get_method,
)
from xitorch_tpu_torch.utils.tensor import (  # noqa: F401
    einsum_hi, dot_hi, ieee_f32, tallqr, create_random_square_matrix,
    create_random_ortho_matrix,
)
from xitorch_tpu_torch.utils.types import (  # noqa: F401
    get_np_dtype, get_torch_dtype, get_complex_dtype, get_real_dtype,
)
from xitorch_tpu_torch.utils.decorators import deprecated  # noqa: F401
from xitorch_tpu_torch.utils.attr import get_attr, set_attr, del_attr  # noqa: F401
