from xitorch_tpu_torch.interpolate.interp1 import Interp1D  # noqa: F401
