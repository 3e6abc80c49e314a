"""Version of the PyTorch/CUDA port (the JAX package's base version).

Unlike xitorch_tpu/version.py, no git probe runs at import time: importing
the package starts no process.
"""

__all__ = ["__version__"]

__version__ = "0.2.0"
