from xitorch_tpu_torch.integrate.quad import quad  # noqa: F401
from xitorch_tpu_torch.integrate.solve_ivp import solve_ivp  # noqa: F401
from xitorch_tpu_torch.integrate.mcquad import mcquad  # noqa: F401
