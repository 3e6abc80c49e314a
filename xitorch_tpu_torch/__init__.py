"""xitorch_tpu_torch: the PyTorch/CUDA port of xitorch_tpu.

The same public surface as the JAX package, written in PyTorch, with the
JAX package's Pallas TPU kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with ``nvcc`` at first use).  First and second order
gradients flow through solver solutions by implicit differentiation, not
through iterations.

Ported so far (see ROADMAP.md for the rest):

* ``LinearOperator``, ``MatrixLinearOperator``, ``checklinop``
* ``TridiagLowRankOperator``, ``BandedLowRankOperator``, ``KronOperator``,
  ``KronSumOperator``
* ``linalg.solve`` with cg / cg_ir / fused_cg / structured_cg / kron_direct /
  minres / bicgstab / gmres / exactsolve / scipy_gmres / broyden1
* ``optimize.rootfinder`` / ``equilibrium`` / ``minimize`` (broyden1/2,
  newton, linearmixing, anderson_acc, gd, adam, lbfgs) with implicit
  gradients of any order, and ``grad.jac`` / ``hess`` as matrix-free
  operators
* ``linalg.symeig`` / ``lsymeig`` / ``usymeig`` / ``svd`` with exacteig /
  kron_exact / davidson / chebfsi, forward and (implicit) gradient, real and
  complex
* ``integrate.solve_ivp`` (rk45, rk23, rk4, rk38, mid_point, euler,
  bwd_euler, trapezoidal, sdirk2; autograd or backsolve adjoint; dict,
  tuple and list states; the adaptive methods under ``torch.func.vmap``),
  ``integrate.quad`` (leggauss, tanhsinh) and ``integrate.mcquad`` (mh,
  mhcustom, dummy1d) and ``integrate.SQuad`` (cspline, simpson, trapz)
* ``interpolate.Interp1D`` (cspline with four boundary conditions, pchip,
  linear; every extrapolation): the natural and clamped splines on 128 or
  more knots solve for their slopes through the Thomas kernel
* ``EditableModule``, ``Packer``, ``make_pure`` / ``get_pure_function``,
  ``make_sibling``; ``debug.profile`` / ``annotate`` on ``torch.profiler``
  and ``python -m xitorch_tpu_torch.debug script.py``; the ``utils``
  helpers of the JAX package (dtype maps, attribute paths, ``deprecated``,
  ``tuple_axpy1``, the random test matrices)
* ``models``: the SCF loop (``HamiltonianOp``, ``scf_density``,
  ``scf_energy``: symeig nested in equilibrium), the DEQ model
  (``init_deq``, ``deq_forward``, ``deq_loss``, ``train_step`` with a
  ``torch.optim`` optimizer) and the neural ODE (``init_node``,
  ``node_forward``, ``node_loss``); where these differ from the JAX
  package's calls: ``PARITY.md`` beside this file
* ``ops``: the structured CG kernel, the fused dense CG kernel, the Thomas
  kernel, the one-sided
  Jacobi sweep kernels for real and for complex input (``jacobi_eigh``,
  ``jacobi_svd``) and the spectral divide-and-conquer warm start, single
  shot and one level a launch (``dc_kernel``, ``dc_level``,
  ``spectral_dc``), each kernel with its plain PyTorch version
"""
from xitorch_tpu_torch._core.linop import (  # noqa: F401
    LinearOperator, MatrixLinearOperator, checklinop,
)
from xitorch_tpu_torch._core.structured import (  # noqa: F401
    BandedLowRankOperator, TridiagLowRankOperator,
)
from xitorch_tpu_torch._core.kron import KronOperator, KronSumOperator  # noqa: F401
from xitorch_tpu_torch._core.editable_module import EditableModule  # noqa: F401
from xitorch_tpu_torch._core.packer import Packer  # noqa: F401
from xitorch_tpu_torch._core.pure import make_pure, make_sibling  # noqa: F401
from xitorch_tpu_torch.debug.modes import (  # noqa: F401
    set_debug_mode, is_debug_enabled, enable_debug, disable_debug,
)
from xitorch_tpu_torch.utils.exceptions import (  # noqa: F401
    GetSetParamsError, ConvergenceWarning, MathWarning,
)
from xitorch_tpu_torch.utils.convergence import assert_converged  # noqa: F401
from xitorch_tpu_torch.version import __version__  # noqa: F401

# the reference's name for make_pure
get_pure_function = make_pure

from xitorch_tpu_torch import (  # noqa: F401,E402
    linalg, ops, debug, utils, grad, optimize, integrate, interpolate, models,
)
