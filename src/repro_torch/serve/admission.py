"""Admission policies: which queued requests form the next prefill batch.

This is the serving-side counterpart of `repro_torch.data.composer` — the same
insight (a data-blind draw mixes fat multimodal items into thin ones and
pays for the mix) applied to a latency-bounded queue instead of a
staleness-bounded reorder window:

  * deadline slack replaces ``max_staleness``: each pending request's
    slack is measured in *expected batch durations* and the shared
    `edf_forced_count` reservation force-admits the requests whose
    deadlines would otherwise become infeasible — the composer's
    no-starvation argument carries over verbatim (slack is monotonically
    non-increasing in time, so every request is eventually forced);
  * candidates are `sorted_runs` over the non-forced pool, keyed by LLM
    sequence length — prefill batches are padded to a power-of-two max
    length, so contiguous runs of similar-length requests minimize
    padding waste exactly as homogeneous compose windows minimize
    bottleneck skew;
  * scoring is work-normalized (padded batch duration per second of
    useful prefill work), with a `recompile_penalty` for opening a
    (rows, padded-seq) compile bucket no earlier batch paid for.

`PrefillPricer` is the shared pricing oracle: predicted base durations
come from the profiled `PerfModel` (`e_dur`/`l_dur`, the same duration
path training scheduling uses) refined by the `OnlineCalibrator`, and are
memoized per request — re-priced only when drift flushes the memo
(`flush()`), which is the engine's "drift-triggered re-estimation".

>>> from repro_torch.data.composer import edf_forced_count
>>> edf_forced_count([0, 3, 3, 3], per_step=4)   # one request is due now
1
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiling.flops import module_flops
from repro_torch.data.composer import _pow2, edf_forced_count, sorted_runs

from repro_torch.serve.request import Request


class PrefillPricer:
    """Predicted serving costs under the profiled perf model.

    ``price()`` (calibrator-refined base prefill cost) is memoized by the
    request's shape key (b(d), s(d)) — base durations and calibration
    corrections are pure functions of those shapes, so the memo is exact.
    A shape is priced once when admission first scores it and re-priced
    only after ``flush()``.  The memo is deliberate — it makes drift
    events *mean* something mechanically (stale prices persist until the
    drift detector fires) and keeps admission scoring O(new shapes) per
    batch.
    """

    def __init__(self, perf, tokens_per_media_item: int, *, tp: int = 1,
                 calibrator=None):
        self.perf = perf
        self.tpm = tokens_per_media_item
        self.tp = int(tp)
        self.calibrator = calibrator
        self._base: Dict[Tuple[int, int], Tuple[float, float, int]] = {}
        self._lpad: Dict[int, float] = {}
        self._price: Dict[Tuple[int, int], float] = {}
        self._decode_fit: Dict[int, float] = {}   # pow2 ctx bucket -> ratio
        self.n_flushes = 0
        # decode FLOPs are affine in the cache length (one token against a
        # kv of c): fit fl(c) = fl0 + fl1*c from two exact evaluations
        f1 = module_flops(perf.llm.cfg, 1, 1, mode="decode", cache_len=1.0)
        f2 = module_flops(perf.llm.cfg, 1, 1, mode="decode", cache_len=2.0)
        self._fl1 = f2.total - f1.total
        self._fl0 = f1.total - self._fl1

    # ------------------------------------------------------------------ #
    def shapes(self, req: Request) -> Tuple[int, int]:
        """(encoder effective batch, LLM seq len) — §3.2.2's (b(d), s(d))."""
        return req.item.encoder_batch(), req.item.llm_seq_len(self.tpm)

    def base(self, req: Request) -> Tuple[float, float, int]:
        """(total base prefill s, LLM part s, seq len) — pure perf model,
        calibration-free (the oracle scales this to produce actuals)."""
        b, s = self.shapes(req)
        hit = self._base.get((b, s))
        if hit is None:
            e = self.perf.e_dur(b, self.tp, "prefill")
            l = self.perf.l_dur(s, self.tp, "prefill")
            hit = self._base[(b, s)] = (e + l, l, s)
        return hit

    def l_pad(self, s_pad: int) -> float:
        hit = self._lpad.get(s_pad)
        if hit is None:
            hit = self._lpad[s_pad] = self.perf.l_dur(s_pad, self.tp,
                                                      "prefill")
        return hit

    def pad_extra(self, req: Request, s_pad: int) -> float:
        """Deterministic padding overhead: the LLM prefill runs at the
        batch's padded length, not the request's own."""
        _, l, s = self.base(req)
        return max(self.l_pad(s_pad) - l, 0.0)

    def price(self, req: Request) -> float:
        """Calibrator-refined base prefill cost (memoized, see class doc)."""
        key = self.shapes(req)
        hit = self._price.get(key)
        if hit is None:
            base, _, s = self.base(req)
            hit = base
            if self.calibrator is not None:
                hit = self.calibrator.correct("prefill", s, self.tp, base)
            self._price[key] = hit
        return hit

    def predict(self, req: Request, s_pad: int) -> float:
        """Predicted cost of this request inside a batch padded to s_pad."""
        return self.price(req) + self.pad_extra(req, s_pad)

    # ------------------------------------------------------------------ #
    def decode_tok_base_s(self, cache_len: float) -> float:
        """Raw perf-model one-token decode cost at context `cache_len`
        (affine FLOPs fit / achievable throughput) — calibration-free."""
        fl = self._fl0 + self._fl1 * max(cache_len, 1.0)
        return fl / self.perf.llm.thr_all(max(cache_len, 1.0), self.tp)

    def decode_tok_s(self, cache_len: float) -> float:
        """Predicted one-token decode step cost at context `cache_len`:
        the raw fit refined by the calibrator's "decode" cells.  The
        per-pow2-context-bucket ratio is memoized (`_decode_fit`) exactly
        like prefill prices — stale until ``flush()`` — so a drift fire
        re-estimates *both* halves of the serving cost model.  Without
        decode observations (the emulation never feeds any) the ratio is
        identically 1.0 and this is bit-equal to the raw fit."""
        base = self.decode_tok_base_s(cache_len)
        if self.calibrator is None:
            return base
        b = _pow2(int(max(cache_len, 1.0)))
        ratio = self._decode_fit.get(b)
        if ratio is None:
            ratio = self._decode_fit[b] = self.calibrator.correct(
                "decode", float(b), self.tp, 1.0)
        return base * ratio

    def decode_estimate(self, req: Request) -> float:
        """Expected total decode time: max_new steps at the mean context."""
        _, _, s = self.base(req)
        mid = s + req.max_new_tokens / 2.0
        return req.max_new_tokens * self.decode_tok_s(mid)

    def flush(self) -> None:
        """Drop memoized *prices* — prefill prices AND decode-step
        token-cost fits — so both are re-estimated under the post-drift
        calibration (a drift fire that re-priced prefill but kept stale
        decode fits would mis-score every decode_estimate).  Base
        durations are calibration-free and stay cached."""
        self._price.clear()
        self._decode_fit.clear()
        self.n_flushes += 1


class FIFOAdmission:
    """Data-blind baseline: admit the oldest pending requests."""

    name = "fifo"

    def select(self, pending: Sequence[Request], now_s: float,
               max_batch: int) -> List[Request]:
        return list(pending[:max_batch])

    def note_batch(self, duration_s: float) -> None:
        pass


class SLOAdmission:
    """Latency-SLO-bounded lookahead admission (data-aware)."""

    name = "slo"

    def __init__(self, pricer: PrefillPricer, *, handoff_s: float = 0.0,
                 recompile_penalty: float = 0.15, max_candidates: int = 32,
                 quantum_alpha: float = 0.25, starvation_horizon: int = 8):
        self.pricer = pricer
        self.handoff_s = handoff_s       # engine's mean KV-handoff estimate
        self.recompile_penalty = recompile_penalty
        self.max_candidates = max_candidates
        self.quantum_alpha = quantum_alpha
        # admission rounds a deadline-infeasible ("hopeless") request may
        # wait before it is force-admitted anyway (no-starvation backstop)
        self.starvation_horizon = starvation_horizon
        self._quantum: Optional[float] = None   # EWMA batch duration
        self._seen_shapes: set = set()
        self.last_n_forced = 0
        self.last_n_candidates = 0

    # ------------------------------------------------------------------ #
    def note_batch(self, duration_s: float) -> None:
        """Observed prefill batch duration — the slack quantum (how many
        seconds one admission round retires)."""
        if self._quantum is None:
            self._quantum = duration_s
        else:
            self._quantum += self.quantum_alpha * (duration_s - self._quantum)

    def _batch_score(self, reqs: List[Request]) -> Tuple[float, tuple]:
        s_pad = _pow2(max(self.pricer.base(r)[2] for r in reqs))
        dur = sum(self.pricer.predict(r, s_pad) for r in reqs)
        work = sum(self.pricer.price(r) for r in reqs)
        score = dur / max(work, 1e-12)
        key = (_pow2(len(reqs)), s_pad)
        if self.recompile_penalty > 0.0 and key not in self._seen_shapes:
            score *= 1.0 + self.recompile_penalty
        return score, key

    def select(self, pending: Sequence[Request], now_s: float,
               max_batch: int) -> List[Request]:
        if not pending:
            return []
        n = min(max_batch, len(pending))
        p = self.pricer
        # per-request slack, in units of expected admission rounds
        remaining = np.array([p.predict(r, _pow2(p.base(r)[2]))
                              + self.handoff_s + p.decode_estimate(r)
                              for r in pending])
        quantum = self._quantum if self._quantum else float(
            np.mean([p.price(r) for r in pending[:n]])) * n
        quantum = max(quantum, 1e-9)
        slack_s = np.array([r.slack_s(now_s, w)
                            for r, w in zip(pending, remaining)])
        # Deadline-feasible requests carry EDF slack in units of admission
        # rounds.  Infeasible ("hopeless") requests are *excluded* from the
        # deadline reservation — forcing them would spend the batch on
        # requests that miss their SLO either way, which is exactly how a
        # saturated queue degenerates to FIFO — and instead age toward an
        # admission-round starvation horizon, so slack is monotonically
        # non-increasing in time for every request and no request starves.
        waited_b = np.floor(np.array([now_s - r.arrival_s
                                      for r in pending]) / quantum)
        slack_b = np.where(
            slack_s >= 0.0,
            np.floor(slack_s / quantum),
            np.maximum(self.starvation_horizon - waited_b, 0.0)).astype(int)
        need = edf_forced_count(slack_b, n)
        # Aging quota: at most half the batch is deadline/age-forced.  An
        # uncapped reservation floods every batch under sustained overload
        # (all slack clamps to 0) and the policy degenerates to FIFO right
        # where reordering matters most; with the cap, every batch keeps
        # homogeneous-run seats (throughput) while the quota still drains
        # forced requests at a strictly positive rate (no starvation —
        # forced order is by slack then arrival, so an aged request's
        # position in the forced queue is monotonically non-increasing).
        forced_cap = max(1, n // 2)
        order = np.argsort(slack_b, kind="stable")       # ties: arrival
        forced = sorted(int(i) for i in order[:min(need, forced_cap)])
        forced_set = set(forced)
        pool = [i for i in range(len(pending)) if i not in forced_set]
        k = n - len(forced)
        # candidate 0 is the FIFO draw, so ties resolve toward FIFO and
        # the policy degenerates gracefully when all prices agree
        cands: List[Tuple[int, ...]] = [tuple(forced) + tuple(pool[:k])]
        if k > 0:
            seqs = [float(p.base(pending[i])[2]) for i in pool]
            for run in sorted_runs(seqs, k, self.max_candidates):
                cands.append(tuple(forced) + tuple(pool[j] for j in run))
        best, best_score, best_key = None, float("inf"), ()
        for c in cands:
            reqs = [pending[i] for i in c]
            score, key = self._batch_score(reqs)
            if score < best_score:
                best, best_score, best_key = c, score, key
        self._seen_shapes.add(best_key)
        self.last_n_forced = len(forced)
        self.last_n_candidates = len(cands)
        return [pending[i] for i in best]
