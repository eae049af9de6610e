"""Full float32 for the reference: no TF32 in cuDNN or in matrix products,
for the length of a ``with`` block."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
