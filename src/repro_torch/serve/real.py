"""Real execution backend: the serving loop drives the model on the card.

`EmulatedBackend` prices the serving physics from the perf model;
`RealBackend` *runs* them on a PyTorch model and reports measured
wall-clock durations, which feed the same calibrator → Page–Hinkley →
re-price path as the emulation's oracle durations.

Execution substrate (all from `repro_torch.serve.steps`):

  * **prefill** — per request, at the prompt's exact length, in
    `pow2_chunks`: every chunk teacher-forces its tokens through
    `decode_step`, so the handoff is numerically the path decode continues
    on (token-identical to a solo run);
  * **handoff** — ``.to(device)`` of the request's B=1 cache from its
    prefill worker's device to a decode worker's (`serve_device_pools`; on
    one card both pools wrap onto it and the move is a no-op);
  * **decode** — per-worker continuous batch at ``decode_slots`` rows,
    occupied rows compacted to a prefix and each step run on the pow2
    occupancy bucket that holds them (the buckets `SLOAdmission` reasons
    about); `merge_cache_row`/`clear_cache_row`/`extract_cache_row`
    implement join, leave and preemption-park.

Each call is timed on the host clock and ends with a device synchronize on
the card.  ``warmup()`` runs every chunk size and bucket once before
serving, so no measured duration holds a first call's set-up, and records
unit costs.  ``probe()`` seeds the calibrator's "prefill"/"decode" cells
with a few measured shapes (the perf model predicts accelerator-seconds,
the host measures wall-seconds; without a probe the first admission rounds
price in the wrong unit system by orders of magnitude).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.pytree import tree_map
from repro_torch.data.composer import _pow2
from repro_torch.launch.mesh import serve_device_pools
from repro_torch.models import model as model_lib
from repro_torch.models.layers.attention import kv_cache_bytes
from repro_torch.serve.backend import (DecodeOutcome, ExecutionBackend,
                                       PrefillOutcome)
from repro_torch.serve.request import Request
from repro_torch.serve.steps import (chunk_step, clear_cache_row,
                                     extract_cache_row, merge_cache_row,
                                     pow2_chunks)


def _decode_bucket(cfg, params, caches, tok, pos, n_pad: int):
    """One decode step over the occupied pow2 prefix ``[0, n_pad)`` of a
    worker's caches: the prefix views are written in place, so the full
    caches hold the step.  Returns (logits (n_pad, vocab), caches)."""
    part = tree_map(lambda a: a[:n_pad], caches)
    logits, _, _ = model_lib.decode_step(params, cfg, tok[:n_pad], part,
                                         pos[:n_pad])
    return logits, caches


class _Prefilled:
    """A prefilled request awaiting handoff/join: its B=1 cache, the
    argmax first token, the prompt length, and the device it lives on."""

    __slots__ = ("cache", "tok0", "length", "device")

    def __init__(self, cache, tok0, length, device):
        self.cache, self.tok0 = cache, tok0
        self.length, self.device = length, device


class _WorkerState:
    """One decode worker's device-resident continuous batch.  Occupied
    slots are always the prefix [0, n_active) — `release` compacts by
    moving the last row into the freed slot."""

    def __init__(self, device, cfg, slots, max_len, kv_dtype):
        self.device = device
        self.caches = model_lib.init_cache(cfg, slots, max_len, kv_dtype,
                                           device=device)
        self.tok = np.zeros(slots, np.int32)
        self.pos = np.zeros(slots, np.int32)
        self.reqs: List[Optional[Request]] = [None] * slots
        self.n_active = 0


class RealBackend(ExecutionBackend):
    """Measured execution on the model behind the backend-agnostic serving
    loop.

    The loop calls eagerly (prefill at admission, decode at each step
    boundary); each call runs on this backend's devices, waits for them,
    and returns its measured wall duration, which the loop replays on the
    virtual clock and feeds to the calibrator."""

    name = "real"
    observes_decode = True

    def __init__(self, model_cfg, params, pricer, serve_cfg, *,
                 max_len: int = 128, chunk: int = 16,
                 kv_dtype=torch.float32, devices=None, warmup: bool = True):
        self.cfg = model_cfg
        self.pricer = pricer
        self.serve = serve_cfg
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.kv_dtype = kv_dtype
        self.prefill_devs, self.decode_devs = serve_device_pools(
            serve_cfg.n_prefill_workers, serve_cfg.n_decode_workers, devices)
        self._params: Dict = {}
        for d in {*self.prefill_devs, *self.decode_devs}:
            self._params[d] = tree_map(lambda x, d=d: x.detach().to(d), params)
        self._cards = sorted({d for d in self._params if d.type == "cuda"},
                             key=str)
        self._workers = [
            _WorkerState(d, model_cfg, serve_cfg.decode_slots, self.max_len,
                         kv_dtype) for d in self.decode_devs]
        self._pre: Dict[int, _Prefilled] = {}     # id(req) -> prefilled
        self._parked: Dict[int, _Prefilled] = {}  # id(req) -> preempted
        self._slot: Dict[int, int] = {}           # id(req) -> worker slot
        self._seen_shapes: set = set()
        self._rr = 0                              # handoff target rotation
        self.unit_costs: Dict[str, float] = {}
        if warmup:
            self.warmup()

    # ------------------------------------------------------------------ #
    def prompt_for(self, req: Request) -> np.ndarray:
        """Deterministic synthetic prompt for a request: the engine's
        requests are shape descriptors (`DataItem`), not token streams, so
        the backend materializes tokens from (item_id, seq len) — solo
        replays in tests regenerate the identical prompt."""
        seq = req.item.llm_seq_len(self.pricer.tpm)
        length = max(1, min(int(seq), self.max_len - req.max_new_tokens - 1))
        rng = np.random.default_rng([int(req.item.item_id), 1223])
        return rng.integers(2, self.cfg.vocab_size, size=length,
                            dtype=np.int64).astype(np.int32)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        for d in self._cards:
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0

    def _fresh_cache(self, batch, dev):
        return model_lib.init_cache(self.cfg, batch, self.max_len,
                                    self.kv_dtype, device=dev)

    def _prefill_chunks(self, params, caches, toks, on_chunk):
        """Teacher-force ``toks`` (1, S) chunk by chunk, each timed and
        reported to ``on_chunk(clen, seconds)``.  Returns (logits, caches)."""
        logits, pos0 = None, 0
        for clen in pow2_chunks(toks.shape[1], self.chunk):
            (logits, caches), dt = self._timed(
                chunk_step, self.cfg, params, caches,
                toks[:, pos0:pos0 + clen], pos0)
            pos0 += clen
            on_chunk(clen, dt)
        return logits, caches

    # ------------------------------------------------------------------ #
    def prefill(self, worker: int, batch: Sequence[Request],
                s_pad: int) -> PrefillOutcome:
        dev = self.prefill_devs[worker % len(self.prefill_devs)]
        params = self._params[dev]
        chunks: List[float] = []
        actuals: List[float] = []
        n_new = 0
        for r in batch:
            prompt = self.prompt_for(r)
            toks = torch.as_tensor(prompt[None, :], device=dev)
            n_before = len(chunks)

            def on_chunk(clen, dt):
                nonlocal n_new
                chunks.append(dt)
                key = ("prefill", str(dev), clen)
                if key not in self._seen_shapes:
                    self._seen_shapes.add(key)
                    n_new += 1

            logits, caches = self._prefill_chunks(
                params, self._fresh_cache(1, dev), toks, on_chunk)
            tok0 = int(torch.argmax(logits[0]))
            self._pre[id(r)] = _Prefilled(caches, tok0, len(prompt), dev)
            actuals.append(sum(chunks[n_before:]))
        return PrefillOutcome(duration_s=float(sum(chunks)),
                              per_request_actual=tuple(actuals),
                              chunks=tuple(chunks), n_new_shapes=n_new)

    # ------------------------------------------------------------------ #
    def handoff(self, req: Request) -> float:
        """Transfer of the request's B=1 cache to a (round-robin) decode
        device; returns the measured seconds."""
        art = self._pre[id(req)]
        dev = self.decode_devs[self._rr % len(self.decode_devs)]
        self._rr += 1
        moved, dt = self._timed(lambda c: tree_map(lambda a: a.to(dev), c),
                                art.cache)
        art.cache, art.device = moved, dev
        return dt

    def handoff_s_mean(self) -> float:
        # admission-slack estimate only (the real transfer is measured)
        return kv_cache_bytes(self.cfg, 1024, self.serve.kv_bytes_per_value) \
            / (self.serve.kv_bandwidth_gbps * 1e9) + self.serve.kv_latency_s

    # ------------------------------------------------------------------ #
    def join(self, worker: int, req: Request) -> None:
        w = self._workers[worker]
        art = self._parked.pop(id(req), None)
        if art is None:
            art = self._pre.pop(id(req))
        slot = w.n_active
        # merge_cache_row moves a cache from another device itself
        w.caches = merge_cache_row(w.caches, art.cache, row=slot)
        w.tok[slot] = art.tok0
        w.pos[slot] = art.length
        w.reqs[slot] = req
        self._slot[id(req)] = slot
        w.n_active += 1

    def decode_step(self, worker: int,
                    active: Sequence[Request]) -> DecodeOutcome:
        w = self._workers[worker]
        n = len(active)
        assert n == w.n_active, (n, w.n_active)
        n_pad = min(_pow2(n), self.serve.decode_slots)
        tok = torch.as_tensor(w.tok, device=w.device)
        pos = torch.as_tensor(w.pos, device=w.device)
        (logits, w.caches), dt = self._timed(
            _decode_bucket, self.cfg, self._params[w.device], w.caches, tok,
            pos, n_pad)
        n_new = 0
        key = ("decode", str(w.device), n_pad)
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            n_new += 1
        nxt = torch.argmax(logits, dim=-1).tolist()
        for r in active:
            slot = self._slot[id(r)]
            r.generated.append(int(w.tok[slot]))   # the token fed this step
            w.tok[slot] = nxt[slot]
            w.pos[slot] += 1
        return DecodeOutcome(duration_s=dt, n_new_shapes=n_new)

    def release(self, worker: int, req: Request, park: bool = False) -> None:
        w = self._workers[worker]
        slot = self._slot.pop(id(req))
        if park:
            # snapshot the row before compaction overwrites it; the parked
            # state re-joins (possibly on another worker) bit-for-bit
            self._parked[id(req)] = _Prefilled(
                extract_cache_row(w.caches, slot), int(w.tok[slot]),
                int(w.pos[slot]), w.device)
        w.n_active -= 1
        last = w.n_active
        if slot != last:                 # compact: move last row into slot
            w.caches = merge_cache_row(w.caches, w.caches, row=slot,
                                       src_row=last)
            moved = w.reqs[last]
            w.reqs[slot] = moved
            self._slot[id(moved)] = slot
            w.tok[slot] = w.tok[last]
            w.pos[slot] = w.pos[last]
        w.caches = clear_cache_row(w.caches, last)
        w.reqs[last] = None

    # ------------------------------------------------------------------ #
    def warmup(self) -> Dict[str, float]:
        """Run the bounded shape set once up front (chunk sizes per prefill
        device, occupancy buckets per decode device) so measured serving
        durations exclude first calls, and record unit costs
        (`unit_costs`) from a second run of each."""
        sizes = sorted({self.chunk} | {1 << k for k in
                                       range((self.chunk - 1).bit_length())})
        for dev in dict.fromkeys(self.prefill_devs):
            params = self._params[dev]
            caches = self._fresh_cache(1, dev)
            for clen in sizes:
                toks = torch.full((1, clen), 2, dtype=torch.int32, device=dev)
                _, dt = self._timed(chunk_step, self.cfg, params, caches, toks, 0)
                _, dt = self._timed(chunk_step, self.cfg, params, caches, toks, 0)
                if clen == self.chunk:
                    self.unit_costs["prefill_s_per_tok"] = dt / clen
        slots = self.serve.decode_slots
        buckets = sorted({min(_pow2(k), slots) for k in range(1, slots + 1)})
        for w in self._workers:
            params = self._params[w.device]
            tok = torch.zeros(slots, dtype=torch.int32, device=w.device)
            pos = torch.zeros(slots, dtype=torch.int32, device=w.device)
            caches = self._fresh_cache(slots, w.device)
            for b in buckets:
                _, dt = self._timed(_decode_bucket, self.cfg, params, caches,
                                    tok, pos, b)
                _, dt = self._timed(_decode_bucket, self.cfg, params, caches,
                                    tok, pos, b)
                self.unit_costs[f"decode_step_s_b{b}"] = dt
        self.unit_costs["decode_step_s"] = \
            self.unit_costs[f"decode_step_s_b{buckets[-1]}"]
        return self.unit_costs

    def probe(self, requests: Sequence[Request], *, n_shapes: int = 4,
              n_obs: int = 2) -> None:
        """Seed the pricer's calibrator with measured (prefill, decode)
        observations for up to ``n_shapes`` distinct request shapes, then
        flush the pricer so admission prices in wall seconds from the
        first round.  The perf model predicts accelerator-seconds for the
        profiled arch while the backend measures host wall-seconds — the
        calibrator's per-bucket ratios are exactly the unit conversion,
        but only after at least one observation per bucket."""
        cal = self.pricer.calibrator
        if cal is None:
            return
        seen, reps = set(), []
        for r in requests:
            k = self.pricer.shapes(r)
            if k not in seen:
                seen.add(k)
                reps.append(r)
            if len(reps) >= n_shapes:
                break
        dev = self.prefill_devs[0]
        params = self._params[dev]
        w = self._workers[0]
        slots = self.serve.decode_slots
        for r in reps:
            base, _, s = self.pricer.base(r)
            prompt = self.prompt_for(r)
            toks = torch.as_tensor(prompt[None, :], device=dev)
            for _ in range(n_obs):
                times: List[float] = []
                self._prefill_chunks(params, self._fresh_cache(1, dev), toks,
                                     lambda clen, dt: times.append(dt))
                cal.observe("prefill", s, self.pricer.tp, base, sum(times))
                # decode at occupancy 1, context = the request's seq len
                tok = torch.zeros(slots, dtype=torch.int32, device=w.device)
                pos = torch.full((slots,), len(prompt), dtype=torch.int32,
                                 device=w.device)
                _, ddt = self._timed(_decode_bucket, self.cfg,
                                     self._params[w.device],
                                     self._fresh_cache(slots, w.device), tok,
                                     pos, 1)
                cal.observe("decode", float(_pow2(int(s))), self.pricer.tp,
                            self.pricer.decode_tok_base_s(float(s)), ddt)
        self.pricer.flush()
