"""Online per-(module, shape-bucket, tp) duration calibration.

`AdaptiveCorrection` (§3.4.3) applies a flat multiplicative penalty per
shape bucket, averaged over the whole run.  This module keeps an EWMA of
the observed/predicted duration ratio *per (module, shape bucket, TP
degree)* instead, so the refinement (a) forgets stale kernels after a plan
hot-swap changes TP, and (b) tracks slow residual drift that a lifetime
average would smear.  It is duck-type compatible with the scheduler's
corrector hook: ``correct(module, shape, tp, predicted) -> refined``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.scheduler.adaptive import AdaptiveCorrection


def shape_bucket(shape: float) -> int:
    """Shared log2 bucketing — delegates to AdaptiveCorrection.bucket so the
    two correctors can never bucket the same shape differently."""
    return AdaptiveCorrection.bucket(shape)


def shape_bucket_array(shapes) -> np.ndarray:
    """Vectorized `shape_bucket`.  Must implement the exact same
    round-half-even log2 rule as `AdaptiveCorrection.bucket` (np.rint and
    Python round() both round half to even) — the parity is pinned by
    tests/test_objective.py::test_correct_array_matches_scalar_correct, so
    change both or neither."""
    shapes = np.asarray(shapes, dtype=np.float64)
    return (2.0 ** np.rint(np.log2(np.maximum(shapes, 1.0)))).astype(np.int64)


@dataclass
class _Cell:
    ratio: float = 1.0       # EWMA of actual/predicted
    abs_err: float = 0.0     # EWMA of |actual/predicted − 1|
    n: int = 0


class OnlineCalibrator:
    def __init__(self, *, alpha: float = 0.25, min_obs: int = 2,
                 max_ratio: float = 8.0, deadband: float = 0.02):
        """alpha: EWMA smoothing; min_obs: observations before a cell's
        correction is trusted; max_ratio: clip for outlier measurements;
        deadband: corrections within ±deadband of 1 are not applied."""
        self.alpha = alpha
        self.min_obs = min_obs
        self.max_ratio = max_ratio
        self.deadband = deadband
        self.cells: Dict[Tuple[str, int, int], _Cell] = {}

    # ------------------------------------------------------------------ #
    def observe(self, module: str, shape: float, tp: int,
                predicted: float, actual: float) -> None:
        if predicted <= 0 or actual <= 0:
            return
        r = min(max(actual / predicted, 1.0 / self.max_ratio), self.max_ratio)
        cell = self.cells.setdefault((module, shape_bucket(shape), int(tp)),
                                     _Cell())
        if cell.n == 0:
            cell.ratio = r
            cell.abs_err = abs(r - 1.0)
        else:
            a = self.alpha
            cell.ratio += a * (r - cell.ratio)
            cell.abs_err += a * (abs(r - 1.0) - cell.abs_err)
        cell.n += 1

    def _usable(self, module: str, bucket: int, tp: int):
        cell = self.cells.get((module, bucket, int(tp)))
        if cell is None or cell.n < self.min_obs:
            return None
        if abs(cell.ratio - 1.0) < self.deadband:
            return None
        return cell

    def correct(self, module: str, shape: float, tp: int,
                predicted: float, fallback_shape: float = None) -> float:
        """fallback_shape: where to borrow a ratio when `shape`'s own
        bucket was *never observed*.  The optimizer's mean-shape path asks
        about aggregate bucket sizes the scheduler never predicts (and
        hence the calibrator never observes); the per-item mean-shape
        residual is the best available estimate there.  A bucket that has
        been observed — even immature or inside the deadband — keeps its
        own verdict.  Per-item callers (the scheduler) leave it unset."""
        cell = self._usable(module, shape_bucket(shape), tp)
        if (cell is None and fallback_shape is not None
                and (module, shape_bucket(shape), int(tp)) not in self.cells):
            cell = self._usable(module, shape_bucket(fallback_shape), tp)
        return predicted if cell is None else predicted * cell.ratio

    def correct_array(self, module: str, shapes, tp: int, predicted,
                      fallback_shape: float = None) -> np.ndarray:
        """Vectorized `correct` over parallel (shapes, predicted) arrays —
        the Parallelism Optimizer's duration tables hold one entry per
        k ∈ {1..GBS}, so refinement there must not pay a dict lookup per
        scalar.  Buckets via the same round-log2 rule as `shape_bucket`."""
        shapes = np.asarray(shapes, dtype=np.float64)
        out = np.array(predicted, dtype=np.float64, copy=True)
        if out.size == 0:
            return out
        fb_cell = None
        if fallback_shape is not None:
            fb_cell = self._usable(module, shape_bucket(fallback_shape), tp)
        buckets = shape_bucket_array(shapes)
        for b in np.unique(buckets):
            cell = self._usable(module, int(b), tp)
            if cell is None and (module, int(b), int(tp)) not in self.cells:
                cell = fb_cell           # only truly unobserved buckets
            if cell is not None:
                out[buckets == b] *= cell.ratio
        return out

    # ------------------------------------------------------------------ #
    def residual(self, module: str | None = None) -> float:
        """Mean EWMA |rel error| over mature cells (drift-detector input)."""
        vals = [c.abs_err for (m, _, _), c in self.cells.items()
                if c.n >= self.min_obs and (module is None or m == module)]
        return sum(vals) / len(vals) if vals else 0.0

    def snapshot(self) -> dict:
        return {f"{m}/b{b}/tp{t}": {"ratio": c.ratio, "abs_err": c.abs_err,
                                    "n": c.n}
                for (m, b, t), c in sorted(self.cells.items())}
