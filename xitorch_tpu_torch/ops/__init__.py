from xitorch_tpu_torch.ops.structured_cg import (  # noqa: F401
    fits_structured_cg, structured_cg_cuda, structured_cg_plain, structured_cg_solve,
)
from xitorch_tpu_torch.ops.fused_cg import (  # noqa: F401
    fits_fused_cg, fused_cg_cuda, fused_cg_dense, fused_cg_plain,
)
from xitorch_tpu_torch.ops.tridiag import (  # noqa: F401
    thomas_cuda, thomas_plain, tridiag_matvec, tridiag_solve, tridiag_solve_kernel,
)
from xitorch_tpu_torch.ops.tlr import (  # noqa: F401
    fits_tlr, tlr_grad_cuda, tlr_grad_plain, tlr_residual_cuda, tlr_residual_plain,
)
# (jacobi_eigh is not re-exported under its own name: it would shadow the
# submodule of the same name and its ENABLED switch)
from xitorch_tpu_torch.ops.jacobi_eigh import (  # noqa: F401
    fits_jacobi_sweep, in_jacobi_window, jacobi_svd, jacobi_sweep, jacobi_sweep_cuda,
    jacobi_sweep_plain, use_jacobi_for, use_jacobi_svd_for,
)
# (likewise dc_kernel and spectral_dc stay submodules: both define a
# dc_precondition, the fused one and the plain statement of the algorithm)
from xitorch_tpu_torch.ops.dc_kernel import (  # noqa: F401
    dc_precondition_cuda, dc_precondition_plain, fits_dc_kernel,
)
