"""Per-host data sharding with exactly-once delivery under host churn.

A fleet (`repro_torch.launch.fleet.FleetManager`: hosts of one or more
ranks) splits each global batch across its *alive* hosts.  Membership
churn threatens the loader's exactly-once contract in two directions:

  * a host that **fails mid-step** takes its shard down with it — under
    synchronous data parallelism the whole step's gradient is lost, so
    every item of that step must be re-delivered (at-least-once is not
    enough: it must be the *same* items, in the *same* global-batch
    grouping, or the loss trajectory forks from the fault-free run);
  * a **re-partition** after join/leave must not duplicate or drop the
    items already buffered for the old roster.

Both reduce to atomic step semantics on one queue:

  ``draw()``   — take the next ``gbs`` items off the stream and partition
                 them over the alive roster (round-robin by position, so
                 the *global batch content* is roster-independent — only
                 the per-host split changes with membership);
  ``commit()`` — the step's allreduce completed on every alive host: the
                 batch is final, account it delivered;
  ``abort()``  — the step died (host failure mid-step): requeue the
                 **whole** step at the front, so the next ``draw()`` —
                 typically over the survivors — re-delivers the identical
                 global batch.

Because aborted steps requeue in full and in order, the *committed*
global-batch stream is bit-identical to a fault-free run's — which is
what lets the tests pin loss-trajectory continuity across
checkpoint-free recovery instead of merely bounding divergence.  Pure
Python, a copy of the reference's module.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence


def partition_by_host(items: Sequence, host_ids: Sequence[int]) -> Dict[int, list]:
    """Round-robin split of one global batch over the alive hosts.

    Position-based and deterministic: item ``i`` goes to host
    ``host_ids[i % len(host_ids)]``.  The union (in position order) is
    always the input batch, so re-partitioning the same batch over a
    different roster changes *who loads what*, never *what the step
    trains on*.

    >>> partition_by_host(list("abcdef"), [0, 2, 3])
    {0: ['a', 'd'], 2: ['b', 'e'], 3: ['c', 'f']}
    >>> partition_by_host([], [1])
    {1: []}
    """
    if not host_ids:
        raise ValueError("cannot partition over an empty roster")
    shards: Dict[int, list] = {h: [] for h in host_ids}
    for i, it in enumerate(items):
        shards[host_ids[i % len(host_ids)]].append(it)
    return shards


class HostShardedSource:
    """Exactly-once global-batch source for an elastic fleet.

    ``source`` is a zero-arg callable returning the next chunk of the
    underlying stream (any length >= 1; e.g. ``lambda: ds.sample(gbs)``
    or an epoch iterator's ``next``).  Items queue in stream order;
    ``draw()`` is only ever satisfied from the queue front, so requeued
    (aborted) items win over fresh ones and ordering is preserved.

    >>> stream = iter(range(100))
    >>> src = HostShardedSource(lambda: [next(stream) for _ in range(4)],
    ...                         gbs=4)
    >>> src.draw([0, 1])
    {0: [0, 2], 1: [1, 3]}
    >>> src.abort()               # host 1 died mid-step
    >>> src.draw([0])             # identical batch, survivors only
    {0: [0, 1, 2, 3]}
    >>> src.commit()
    >>> src.draw([0, 2]); src.commit()
    {0: [4, 6], 2: [5, 7]}
    >>> src.n_committed, src.committed[0]
    (2, [0, 1, 2, 3])
    """

    def __init__(self, source: Callable[[], Sequence], gbs: int, *,
                 fleet=None, keep_committed: bool = True):
        """``fleet``: optional `FleetManager`; when set, ``draw()`` may be
        called without a roster and uses ``fleet.alive_ids()``.
        ``keep_committed=False`` drops the committed-batch history (tests
        keep it to assert bit-identical streams; long runs should not)."""
        if gbs < 1:
            raise ValueError(f"gbs must be >= 1, got {gbs}")
        self.source = source
        self.gbs = gbs
        self.fleet = fleet
        self.keep_committed = keep_committed
        self._queue: Deque = deque()
        self._in_flight: Optional[List] = None
        self.committed: List[list] = []     # committed global batches, in order
        self.n_drawn = 0
        self.n_committed = 0
        self.n_aborted = 0

    # ------------------------------------------------------------------ #
    @property
    def in_flight(self) -> Optional[List]:
        """The uncommitted step's global batch (None between steps)."""
        return list(self._in_flight) if self._in_flight is not None else None

    def draw(self, host_ids: Optional[Sequence[int]] = None) -> Dict[int, list]:
        """Take the next global batch and shard it over ``host_ids``
        (default: the attached fleet's alive roster).  Exactly one step
        may be in flight: the previous ``draw()`` must have been
        ``commit()``-ed or ``abort()``-ed first."""
        if self._in_flight is not None:
            raise RuntimeError("previous step still in flight; "
                               "commit() or abort() it before drawing")
        if host_ids is None:
            if self.fleet is None:
                raise ValueError("no host_ids given and no fleet attached")
            host_ids = self.fleet.alive_ids()
        while len(self._queue) < self.gbs:
            chunk = list(self.source())
            if not chunk:
                raise RuntimeError("source exhausted before a full "
                                   f"global batch ({len(self._queue)}"
                                   f"/{self.gbs} items queued)")
            self._queue.extend(chunk)
        batch = [self._queue.popleft() for _ in range(self.gbs)]
        self._in_flight = batch
        self.n_drawn += 1
        return partition_by_host(batch, list(host_ids))

    def commit(self) -> None:
        """Finalize the in-flight step: its batch is delivered exactly
        once and will never be re-drawn."""
        if self._in_flight is None:
            raise RuntimeError("commit() with no step in flight")
        if self.keep_committed:
            self.committed.append(self._in_flight)
        self._in_flight = None
        self.n_committed += 1

    def abort(self) -> None:
        """Roll the in-flight step back: requeue its *entire* batch at the
        queue front (synchronous DP — a lost shard loses the step), so the
        next ``draw()`` re-delivers the identical global batch."""
        if self._in_flight is None:
            raise RuntimeError("abort() with no step in flight")
        self._queue.extendleft(reversed(self._in_flight))
        self._in_flight = None
        self.n_aborted += 1
