"""Multilinear interpolation over rectilinear grids.

The Model Profiler (§3.2.1) measures throughput/memory on a sparse grid of
input shapes × TP degrees and predicts intermediate shapes by linear
interpolation — "we model activation memory via linear interpolation based on
the effective batch size ... and sequence length".  Extrapolation clamps to
the hull (conservative for memory, flat for throughput).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class GridInterpolator:
    """f: R^k -> R sampled on an outer-product grid of sorted axis points."""

    def __init__(self, axes: Sequence[np.ndarray], values: np.ndarray):
        self.axes = [np.asarray(a, dtype=np.float64) for a in axes]
        self.values = np.asarray(values, dtype=np.float64)
        if tuple(len(a) for a in self.axes) != self.values.shape:
            raise ValueError(
                f"grid shape {tuple(len(a) for a in self.axes)} != "
                f"values shape {self.values.shape}")
        for a in self.axes:
            if len(a) == 0 or np.any(np.diff(a) <= 0):
                raise ValueError("axes must be non-empty and strictly increasing")

    def __call__(self, *coords: float) -> float:
        return float(self.batch(np.asarray(coords, dtype=np.float64)[None])[0])

    def batch(self, pts: np.ndarray) -> np.ndarray:
        """pts: (n, k) -> (n,) interpolated values (clamped extrapolation)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        n, k = pts.shape
        if k != len(self.axes):
            raise ValueError(f"expected {len(self.axes)} coords, got {k}")
        los, fracs = [], []
        for i, ax in enumerate(self.axes):
            x = np.clip(pts[:, i], ax[0], ax[-1])
            hi_idx = np.searchsorted(ax, x, side="left")
            hi_idx = np.clip(hi_idx, 1, len(ax) - 1) if len(ax) > 1 else \
                np.zeros(n, dtype=int)
            lo_idx = hi_idx - 1 if len(ax) > 1 else np.zeros(n, dtype=int)
            if len(ax) > 1:
                denom = ax[hi_idx] - ax[lo_idx]
                frac = (x - ax[lo_idx]) / denom
            else:
                frac = np.zeros(n)
            los.append(lo_idx)
            fracs.append(frac)
        out = np.zeros(n)
        # sum over 2^k corners
        for corner in range(1 << k):
            idx = []
            weight = np.ones(n)
            for i in range(k):
                if corner >> i & 1 and len(self.axes[i]) > 1:
                    idx.append(los[i] + 1)
                    weight = weight * fracs[i]
                else:
                    idx.append(los[i])
                    if len(self.axes[i]) > 1:
                        weight = weight * (1.0 - fracs[i])
            out += weight * self.values[tuple(idx)]
        return out
