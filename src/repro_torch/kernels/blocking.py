"""Grid-blocking policy shared by the plain (CPU) versions of the kernels.

An axis is padded up to the next block multiple rather than tiled by the
largest divisor, which would degenerate to block size 1 on prime lengths.
Padded attention positions carry segment id ``PAD_SEGMENT`` (−1), which no
real segment id (≥ 0) equals, so the segment mask hides the tail; padded
query rows are zeroed by the ``l > 0`` guard and sliced off.  The CUDA
kernels mask the ragged edge themselves and need no padding.

>>> pick_block(128, 64)
(64, 128)
>>> pick_block(127, 64)
(64, 128)
>>> pick_block(96, 128)
(96, 96)
>>> pick_block(257, 64)
(64, 320)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PAD_SEGMENT = -1


def pick_block(s: int, target: int) -> tuple:
    """``(block, padded)``: ``block = min(s, target)`` and ``padded`` the
    next multiple of ``block`` ≥ ``s``."""
    b = min(int(s), max(1, int(target)))
    padded = -(-int(s) // b) * b
    return b, padded


def pad_axis(x: torch.Tensor, padded: int, axis: int, value=0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to length ``padded`` with ``value``;
    returns ``x`` itself when the axis already has that length."""
    n = x.shape[axis]
    if n == padded:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - axis - 1) + [0, padded - n]
    return F.pad(x, widths, value=value)
