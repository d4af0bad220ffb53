"""Drift detection over observed shapes and prediction residuals.

Two complementary detectors feed the re-planning trigger:

  * ``PageHinkley`` — sequential change-point test on a scalar stream
    (prediction residuals).  Fires when the cumulative deviation from the
    running mean exceeds ``threshold``; robust to noise via the ``delta``
    slack term.
  * KS distance — two-sample Kolmogorov–Smirnov statistic between the
    profiled reference `ShapeDistribution` and a sliding window of shapes
    observed at runtime.  Fires when either the encoder-batch or the
    LLM-sequence marginal moves by more than ``ks_threshold``.

`DriftDetector` combines both, debounces with a cooldown, and snapshots
the current window as the empirical distribution to re-plan against.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Sequence

import numpy as np

from repro_torch.core.profiling.data_profiler import ShapeDistribution
from repro_torch.data.items import DataItem


class PageHinkley:
    """Two-sided Page–Hinkley test with a burn-in period."""

    def __init__(self, *, delta: float = 0.005, threshold: float = 0.5,
                 burn_in: int = 30):
        self.delta = delta
        self.threshold = threshold
        self.burn_in = burn_in
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m_up = 0.0        # cumulative upward deviation
        self._m_dn = 0.0        # cumulative downward deviation
        self._min_up = 0.0
        self._max_dn = 0.0
        self.statistic = 0.0

    def update(self, x: float) -> bool:
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self._m_up += x - self.mean - self.delta
        self._m_dn += x - self.mean + self.delta
        self._min_up = min(self._min_up, self._m_up)
        self._max_dn = max(self._max_dn, self._m_dn)
        self.statistic = max(self._m_up - self._min_up,
                             self._max_dn - self._m_dn)
        return self.n > self.burn_in and self.statistic > self.threshold


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic: sup |ECDF_a − ECDF_b|."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    if len(a) == 0 or len(b) == 0:
        return 0.0
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


@dataclass(frozen=True)
class DriftEvent:
    kind: str                   # "shape-ks" | "residual-ph"
    statistic: float
    threshold: float
    n_obs: int                  # item/residual count when the test fired


class DriftDetector:
    def __init__(self, *, window: int = 256, ks_threshold: float = 0.2,
                 check_every: int = 32, cooldown: int = 128,
                 ph_delta: float = 0.01, ph_threshold: float = 1.0,
                 ph_burn_in: int = 30):
        self.window = window
        self.ks_threshold = ks_threshold
        self.check_every = check_every
        self.cooldown = cooldown
        self._win_bsz: Deque[float] = deque(maxlen=window)
        self._win_seq: Deque[float] = deque(maxlen=window)
        self._ref_bsz: Optional[np.ndarray] = None
        self._ref_seq: Optional[np.ndarray] = None
        self.ph = PageHinkley(delta=ph_delta, threshold=ph_threshold,
                              burn_in=ph_burn_in)
        self._n_items = 0
        self._since_check = 0
        self._since_event = cooldown        # allow an immediate first event
        self.events: list[DriftEvent] = []

    # ------------------------------------------------------------------ #
    def set_reference(self, dist: ShapeDistribution) -> None:
        self._ref_bsz = np.asarray(dist.enc_batches, dtype=np.float64)
        self._ref_seq = np.asarray(dist.llm_seqs, dtype=np.float64)

    def _fire(self, event: DriftEvent) -> DriftEvent:
        self.events.append(event)
        self._since_event = 0
        return event

    # ------------------------------------------------------------------ #
    def observe_items(self, items: Sequence[DataItem],
                      tokens_per_media_item: int) -> Optional[DriftEvent]:
        for it in items:
            self._win_bsz.append(float(it.encoder_batch()))
            self._win_seq.append(float(it.llm_seq_len(tokens_per_media_item)))
        self._n_items += len(items)
        self._since_check += len(items)
        self._since_event += len(items)
        if (self._ref_seq is None or len(self._win_seq) < self.window
                or self._since_check < self.check_every
                or self._since_event < self.cooldown):
            return None
        self._since_check = 0
        stat = max(ks_distance(self._ref_seq, np.fromiter(self._win_seq, float)),
                   ks_distance(self._ref_bsz, np.fromiter(self._win_bsz, float)))
        if stat > self.ks_threshold:
            return self._fire(DriftEvent("shape-ks", stat, self.ks_threshold,
                                         self._n_items))
        return None

    def observe_residual(self, rel_error: float) -> Optional[DriftEvent]:
        """Feed one |actual/predicted − 1|-style residual."""
        fired = self.ph.update(float(rel_error))
        if fired and self._since_event >= self.cooldown:
            stat = self.ph.statistic
            self.ph.reset()
            return self._fire(DriftEvent("residual-ph", stat,
                                         self.ph.threshold, self._n_items))
        return None

    # ------------------------------------------------------------------ #
    def window_distribution(self) -> ShapeDistribution:
        """Empirical distribution of the recent window (re-plan input)."""
        return ShapeDistribution(np.fromiter(self._win_bsz, float),
                                 np.fromiter(self._win_seq, float))

    def rebase(self, dist: Optional[ShapeDistribution] = None) -> None:
        """Adopt a new reference after a re-plan so the test re-arms
        against the post-drift regime instead of refiring forever."""
        self.set_reference(dist if dist is not None
                           else self.window_distribution())
        self._win_bsz.clear()
        self._win_seq.clear()
        self.ph.reset()
        self._since_check = 0
        self._since_event = 0
