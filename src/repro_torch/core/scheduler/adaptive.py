"""Adaptive Correction (paper §3.4.3).

GPU/TPU stacks pick different kernels per input shape, so a small set of
shapes deviates persistently from interpolation-based predictions.  The
mechanism tracks B = Th_actual − Th_pred per shape bucket, feeds a
multiplicative penalty back to the scheduler's duration estimates, and
toggles itself off when the measured average benefit fails to exceed the
monitoring cost C (cost-benefit analysis, Fig. 15).
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Tuple


@dataclass
class _BucketStats:
    n: int = 0
    ratio_sum: float = 0.0           # sum of actual/pred throughput ratios

    @property
    def correction(self) -> float:
        return self.ratio_sum / self.n if self.n else 1.0


class AdaptiveCorrection:
    def __init__(self, *, monitoring_cost: float = 0.04,
                 window: int = 64, min_obs: int = 3,
                 deviation_threshold: float = 0.05,
                 probe_interval: int = 512, probe_window: int = 16):
        """monitoring_cost: recurring relative overhead C of tracking
        (paper measures ~4%); window: iterations I for the benefit average;
        probe_interval/probe_window: while deactivated, every
        `probe_interval` observations a `probe_window`-long probe re-runs
        the cost-benefit test so the mechanism recovers when deviations
        return (the paper's loop is continuous, not one-way)."""
        self.cost = monitoring_cost
        self.window = window
        self.min_obs = min_obs
        self.threshold = deviation_threshold
        self.probe_interval = probe_interval
        self.probe_window = probe_window
        self.enabled = True
        self.probing = False
        self.stats: Dict[Tuple[str, int], _BucketStats] = defaultdict(_BucketStats)
        self.benefits: Deque[float] = deque(maxlen=window)
        self._iters = 0
        self._disabled_iters = 0
        self._probe_seen = 0

    # ------------------------------------------------------------------ #
    @staticmethod
    def bucket(shape: float) -> int:
        import math
        return int(2 ** round(math.log2(max(1.0, float(shape)))))

    def observe(self, module: str, shape: float, predicted_dur: float,
                actual_dur: float) -> None:
        """Record one execution. Durations are interchangeable with inverse
        throughputs for a fixed workload: B = Th_act − Th_pred ∝
        pred_dur/act_dur − 1."""
        if predicted_dur <= 0 or actual_dur <= 0:
            return
        if not self.enabled:
            # Deactivated: only count iterations (near-zero cost) until the
            # next probe window opens.
            self._disabled_iters += 1
            if self._disabled_iters >= self.probe_interval:
                self.enabled = True
                self.probing = True
                self._probe_seen = 0
                self._disabled_iters = 0
                self.benefits.clear()
            else:
                return
        key = (module, self.bucket(shape))
        st = self.stats[key]
        st.n += 1
        st.ratio_sum += actual_dur / predicted_dur
        # relative benefit of having the corrected estimate for this shape
        self.benefits.append(abs(actual_dur / predicted_dur - 1.0))
        self._iters += 1
        if self.probing:
            self._probe_seen += 1
            if self._probe_seen >= self.probe_window:
                self.probing = False
                avg_b = sum(self.benefits) / len(self.benefits)
                if avg_b < self.cost:
                    self._deactivate()
                else:
                    self._iters = 0          # fresh full window before the
                                             # next cost-benefit re-check
        else:
            self._maybe_toggle()

    def _deactivate(self) -> None:
        self.enabled = False
        self.probing = False
        self._disabled_iters = 0

    def _maybe_toggle(self) -> None:
        if self._iters >= self.window and len(self.benefits) == self.benefits.maxlen:
            avg_b = sum(self.benefits) / len(self.benefits)
            if avg_b < self.cost:
                # benefit does not justify monitoring overhead: deactivate
                self._deactivate()

    # ------------------------------------------------------------------ #
    def correct(self, module: str, shape: float, predicted_dur: float) -> float:
        """Apply the learned penalty to a predicted duration."""
        st = self.stats.get((module, self.bucket(shape)))
        if st is None or st.n < self.min_obs:
            return predicted_dur
        corr = st.correction
        if abs(corr - 1.0) < self.threshold:
            return predicted_dur
        return predicted_dur * corr

    def net_speedup(self) -> float:
        """Average benefit minus monitoring cost (Fig. 15 metric)."""
        if not self.benefits:
            return -self.cost
        return sum(self.benefits) / len(self.benefits) - self.cost
