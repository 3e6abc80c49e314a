from xitorch_tpu_torch.debug.modes import (  # noqa: F401
    set_debug_mode, is_debug_enabled, enable_debug, disable_debug,
)
from xitorch_tpu_torch.debug.profiling import profile, annotate  # noqa: F401
