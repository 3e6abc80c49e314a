from xitorch_tpu_torch.ops.structured_cg import (  # noqa: F401
    fits_structured_cg, structured_cg_cuda, structured_cg_plain, structured_cg_solve,
)
from xitorch_tpu_torch.ops.tridiag import (  # noqa: F401
    thomas_cuda, thomas_plain, tridiag_matvec, tridiag_solve, tridiag_solve_kernel,
)
