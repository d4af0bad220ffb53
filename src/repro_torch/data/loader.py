"""Scheduled data loader: DFLOP scheduler groups -> packed tensor batches.

Integration point of the Online Microbatch Scheduler with the input
pipeline (paper Fig. 3: "integrated into the data loading pipeline").  Each
global batch of DataItems is partitioned into m = N_mb · L_dp buckets by the
scheduler; bucket (i, r) becomes row r of microbatch i, sequence-packed to a
fixed token budget.  Scheduling of batch t+1 overlaps step t via
`scheduler.submit/collect`.

With a `LookaheadComposer` (``composer=``) the item flow becomes
compose → schedule → pack: raw draws feed the composer's reorder window
and the loader consumes *composed* global batches.  By default
(``compose_prefetch=True``) the window refill runs on a background
thread — global batch t+1 is pushed and composed while batch t is being
scored/scheduled — with a depth-2 queue for backpressure; set
``compose_prefetch=False`` to compose inline on the caller thread.  See
``docs/data.md``.

Determinism contract (pinned by ``tests/test_loader.py``): prefetch and
sync modes — and compose-prefetch vs. inline composition — yield
batch-for-batch identical streams.  The two rng streams
(schedule_random seeds vs. packing token draws) are split per concern —
a single shared stream would be consumed in a different interleaving by
the two modes.  The compose worker is the *only* thread touching the
composer, and window ordering never depends on consumer timing, so
threading shifts when composition happens, not what it produces.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler.online import OnlineMicrobatchScheduler, ScheduleOutput
from repro_torch.data.items import DataItem
from repro_torch.data.packing import pack_items
from repro_torch.data.synthetic import MixedDataset


class ScheduledLoader:
    def __init__(self, dataset: Optional[MixedDataset],
                 scheduler: OnlineMicrobatchScheduler, *,
                 gbs: int, token_budget: int, vocab_size: int,
                 random_baseline: bool = False, seed: int = 0,
                 prefetch: bool = True,
                 composer=None,
                 compose_prefetch: bool = True,
                 item_source: Optional[Iterable[Sequence[DataItem]]] = None,
                 metrics=None):
        """composer: optional `repro.data.composer.LookaheadComposer`.
        compose_prefetch: refill/compose the window on a background
        thread (batch t+1 composed while t is scored); False composes
        inline on the caller thread.  Streams are identical either way.
        item_source: optional finite iterable of item batches replacing
        ``dataset.global_batches(gbs)`` (epoch semantics: at exhaustion
        the composer window is drained, so every item is emitted exactly
        once).  metrics: optional `RuntimeMetrics` — per-global-batch
        truncated-token counts land there (``record_pack``)."""
        assert dataset is not None or item_source is not None, \
            "need a dataset or an item_source"
        self.dataset = dataset
        self.scheduler = scheduler
        self.gbs = gbs
        self.budget = token_budget
        self.vocab = vocab_size
        self.random_baseline = random_baseline
        # split streams: seeds for schedule_random vs token draws for
        # pack_items — the sync and prefetch paths interleave the two
        # concerns differently, so sharing one stream would break the
        # mode-equivalence contract
        self._seed_rng = np.random.default_rng(seed)
        self._pack_rng = np.random.default_rng([seed, 1])
        self.prefetch = prefetch
        self.composer = composer
        self.compose_prefetch = compose_prefetch
        self.item_source = item_source
        self.metrics = metrics
        self.last_schedule: Optional[ScheduleOutput] = None
        self.last_truncated: int = 0
        self.total_truncated: int = 0

    # ------------------------------------------------------------------ #
    def _schedule(self, items) -> ScheduleOutput:
        if self.random_baseline:
            return self.scheduler.schedule_random(
                items, seed=int(self._seed_rng.integers(1 << 31)))
        return self.scheduler.schedule(items)

    def _build(self, items: Sequence[DataItem], out: ScheduleOutput) -> dict:
        n_mb = self.scheduler.plan.n_mb
        dp = self.scheduler.plan.llm.dp
        m = n_mb * dp
        groups = out.groups
        assert len(groups) == m
        tokens = np.zeros((n_mb, dp, self.budget), np.int32)
        labels = np.full((n_mb, dp, self.budget), -1, np.int32)
        seg = np.zeros((n_mb, dp, self.budget), np.int32)
        pos = np.zeros((n_mb, dp, self.budget), np.int32)
        truncated = 0
        for g_idx, g in enumerate(groups):
            i, r = divmod(g_idx, dp)
            packed = pack_items([items[j] for j in g], self.budget,
                                self.scheduler.tpm, self.vocab,
                                self._pack_rng)
            truncated += packed.truncated
            tokens[i, r] = packed.tokens[0]
            labels[i, r] = packed.labels[0]
            seg[i, r] = packed.segment_ids[0]
            pos[i, r] = packed.positions[0]
        self.last_truncated = truncated
        self.total_truncated += truncated
        if self.metrics is not None:
            self.metrics.record_pack(truncated)
        return {"tokens": tokens, "labels": labels,
                "segment_ids": seg, "positions": pos}

    # ------------------------------------------------------------------ #
    def _compose_stream(self, gen) -> Iterator[Sequence[DataItem]]:
        """Background-thread composition: the window refill (push raw
        draws, compose ready batches, drain at exhaustion) runs off the
        caller thread, so global batch t+1 is composed while batch t is
        being scored/scheduled.  A depth-2 queue provides backpressure;
        the worker is the only thread touching the composer and executes
        the exact push/compose/drain sequence of the inline path, so the
        emitted stream is bit-identical (pinned by tests/test_loader.py).
        Worker exceptions are re-raised on the caller; abandoning the
        generator early stops the worker via the stop event."""
        import queue as _queue
        import threading
        q: "_queue.Queue" = _queue.Queue(maxsize=2)
        stop = threading.Event()
        _END = object()

        def _put(x) -> bool:
            while not stop.is_set():
                try:
                    q.put(x, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def _work():
            try:
                for raw in gen:
                    self.composer.push(raw)
                    while self.composer.ready:
                        if not _put(self.composer.compose()):
                            return
                for b in self.composer.drain():
                    if not _put(b):
                        return
                _put(_END)
            except BaseException as exc:   # surface on the caller thread
                _put(exc)

        worker = threading.Thread(target=_work, name="compose-prefetch",
                                  daemon=True)
        worker.start()
        try:
            while True:
                got = q.get()
                if got is _END:
                    return
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            stop.set()

    def _item_batches(self) -> Iterator[Sequence[DataItem]]:
        """Upstream global batches: FIFO draws, optionally re-composed
        through the lookahead window (inline or on the compose-prefetch
        thread)."""
        gen = (iter(self.item_source) if self.item_source is not None
               else self.dataset.global_batches(self.gbs))
        if self.composer is None:
            yield from gen
            return
        if self.compose_prefetch:
            yield from self._compose_stream(gen)
            return
        for raw in gen:
            self.composer.push(raw)
            while self.composer.ready:
                yield self.composer.compose()
        # finite stream: exactly-once requires emptying the window
        yield from self.composer.drain()

    def __iter__(self) -> Iterator[dict]:
        gen = self._item_batches()
        if not self.prefetch:
            for items in gen:
                out = self._schedule(items)
                self.last_schedule = out
                yield self._build(items, out)
            return
        # async: schedule batch t+1 while the caller runs step t
        try:
            items = next(gen)
        except StopIteration:
            return
        if self.random_baseline:
            pending_items, pending_out = items, self._schedule(items)
        else:
            self.scheduler.submit(items)
            pending_items, pending_out = items, None
        while True:
            if pending_out is None:
                pending_out = self.scheduler.collect()
            items_next = next(gen, None)
            next_out = None
            if items_next is not None:
                if self.random_baseline:
                    next_out = self._schedule(items_next)
                else:
                    self.scheduler.submit(items_next)
            out, cur_items = pending_out, pending_items
            pending_items = items_next
            pending_out = next_out
            self.last_schedule = out
            yield self._build(cur_items, out)
            if pending_items is None:
                return
