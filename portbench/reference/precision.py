"""The control's precision: TF32, the step below IEEE float32.

A TF32 product reads each float32 operand with 10 explicit mantissa bits
instead of 23.  The control rounds its inputs so, and runs its products
with TF32 allowed (on the card; the CPU has no TF32, and the rounded
inputs carry the control there).
"""
import contextlib

import torch


def round_tf32(t):
    """``t`` (float32) rounded to the nearest value with 10 mantissa bits,
    ties away from zero."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

