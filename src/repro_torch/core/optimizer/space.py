"""Search-space generation (Algorithm 1, phase 1).

Enumerates GPU partitions between the modality encoder and the LLM and all
(TP, PP, DP) factorizations per module.  TP degrees are limited to powers of
two within one high-bandwidth domain (paper Eq. 2: TP "typically limited to
GPUs within the same node"; on TPU the analogue is the mesh's "model" axis).

The plan additionally carries a **schedule family** axis (see
``docs/schedules.md``):

  * ``"1f1b"``         — classic one-forward-one-backward (the default; the
    encoder occupies its own leading pipeline stages).
  * ``"interleaved"``  — Megatron-style interleaved virtual stages: each
    rank hosts ``VIRTUAL_CHUNKS`` model chunks, shrinking the warmup/drain
    bubble by that factor.  Requires ``n_mb % pipeline_depth == 0``.
  * ``"encoder_fill"`` — Optimus-style encoder-in-bubble: the encoder is
    *replicated* across the LLM's pipeline ranks (no dedicated stages) and
    its per-microbatch work, split evenly over the ranks, executes inside
    the 1F1B warmup/drain bubbles.  Requires a colocated encoder
    parallelism ``(tp=L_tp, pp=1, dp=L_dp)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

SCHEDULES = ("1f1b", "interleaved", "encoder_fill")

# Virtual model chunks per rank under the interleaved schedule.  A plan
# does not carry its own chunk count — the search treats the family as one
# axis and the simulator takes `v` explicitly — so the bubble arithmetic
# below and the simulator default stay in sync through this constant.
VIRTUAL_CHUNKS = 2


@dataclass(frozen=True)
class ClusterSpec:
    n_chips: int
    chips_per_node: int = 16          # TP domain size
    mem_bytes: float = 16e9           # per-chip HBM (v5e)
    name: str = "tpu-v5e-pod"

    @property
    def n_nodes(self) -> int:
        return self.n_chips // self.chips_per_node


@dataclass(frozen=True)
class ModuleParallelism:
    tp: int
    pp: int
    dp: int

    @property
    def chips(self) -> int:
        return self.tp * self.pp * self.dp


@dataclass(frozen=True)
class ParallelismPlan:
    """θ = (E_tp, E_pp, E_dp, L_tp, L_pp, L_dp, N_mb, schedule).

    >>> p = ParallelismPlan(llm=ModuleParallelism(2, 4, 1), n_mb=8,
    ...                     schedule="interleaved")
    >>> p.as_tuple()
    (0, 0, 0, 2, 4, 1, 8, 'interleaved')
    >>> p.pipeline_depth, p.bubble_slots
    (4, 1.5)
    """

    llm: ModuleParallelism
    encoder: Optional[ModuleParallelism] = None
    n_mb: int = 1
    schedule: str = "1f1b"

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")
        if self.schedule == "interleaved":
            depth = self.pipeline_depth
            if depth < 2:
                raise ValueError("interleaved schedule needs pipeline "
                                 f"depth >= 2, got {depth}")
            if self.n_mb % depth:
                raise ValueError(
                    f"interleaved schedule needs n_mb divisible by the "
                    f"pipeline depth ({depth}), got n_mb={self.n_mb}")
        if self.schedule == "encoder_fill":
            ep, lp = self.encoder, self.llm
            if ep is None:
                raise ValueError("encoder_fill schedule needs an encoder")
            if (ep.tp, ep.pp, ep.dp) != (lp.tp, 1, lp.dp):
                raise ValueError(
                    "encoder_fill colocates a replicated encoder on the "
                    f"LLM ranks: encoder parallelism must be "
                    f"(tp={lp.tp}, pp=1, dp={lp.dp}), got "
                    f"({ep.tp}, {ep.pp}, {ep.dp})")

    @property
    def pipeline_depth(self) -> int:
        """Number of physical pipeline ranks.  Under ``encoder_fill`` the
        encoder holds no stages of its own — depth is the LLM's alone."""
        if self.schedule == "encoder_fill":
            return self.llm.pp
        e_pp = self.encoder.pp if self.encoder else 0
        return e_pp + self.llm.pp

    @property
    def bubble_slots(self) -> float:
        """Closed-form pipeline fill/drain overhead in units of one
        microbatch slot: step ≈ (n_mb + bubble_slots) · slot cost.  1F1B
        pays depth − 1 slots; interleaving v chunks shrinks that by v;
        encoder_fill keeps the LLM's 1F1B shape (its bubbles are *filled*,
        which the slot cost — see the scheduler — accounts for instead)."""
        slots = self.pipeline_depth - 1
        if self.schedule == "interleaved":
            return slots / VIRTUAL_CHUNKS
        return slots

    @property
    def n_buckets(self) -> int:
        """m = N_mb · L_dp — the partition arity the Online Scheduler (and
        every sampling objective) balances a global batch into."""
        return self.n_mb * self.llm.dp

    @property
    def chips(self) -> int:
        """Physical chips the plan occupies.  The encoder_fill encoder is
        replicated *on* the LLM's chips, so it adds none."""
        if self.schedule == "encoder_fill":
            return self.llm.chips
        return self.llm.chips + (self.encoder.chips if self.encoder else 0)

    def as_tuple(self):
        e = self.encoder or ModuleParallelism(0, 0, 0)
        return (e.tp, e.pp, e.dp, self.llm.tp, self.llm.pp, self.llm.dp,
                self.n_mb, self.schedule)


def _pow2s_up_to(n: int) -> List[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def find_combs(n_chips: int, max_tp: int, *, max_pp: int = 64) -> List[ModuleParallelism]:
    """All (tp, pp, dp) with tp·pp·dp == n_chips (paper's FindCombs)."""
    out = []
    for tp in _pow2s_up_to(min(max_tp, n_chips)):
        if n_chips % tp:
            continue
        rest = n_chips // tp
        for pp in range(1, min(max_pp, rest) + 1):
            if rest % pp:
                continue
            out.append(ModuleParallelism(tp, pp, rest // pp))
    return out


def enumerate_configs(cluster: ClusterSpec, *, has_encoder: bool,
                      max_pp: int = 64, partition_step: int = 1,
                      schedules: Sequence[str] = ("1f1b",),
                      ) -> Iterator[Tuple[Optional[ModuleParallelism], ModuleParallelism, str]]:
    """Phase 1: yield (encoder_parallelism | None, llm_parallelism, schedule).

    The partitioned families (``1f1b``, ``interleaved``) share the same
    chip-split enumeration — the schedule only changes how the candidate is
    scored.  ``encoder_fill`` is its own enumeration: the encoder takes no
    chips of its own (it is replicated on the LLM ranks), so the LLM gets
    the *whole* cluster and the colocated encoder parallelism
    ``(L_tp, 1, L_dp)`` is implied by the LLM's.
    """
    unknown = set(schedules) - set(SCHEDULES)
    if unknown:
        raise ValueError(f"unknown schedule(s) {sorted(unknown)}; "
                         f"expected a subset of {SCHEDULES}")
    N = cluster.n_chips
    max_tp = cluster.chips_per_node
    partitioned = [s for s in schedules if s in ("1f1b", "interleaved")]
    if not has_encoder:
        for lp in find_combs(N, max_tp, max_pp=max_pp):
            for sched in partitioned:
                if sched == "interleaved" and lp.pp < 2:
                    continue
                yield None, lp, sched
        return
    if partitioned:
        for e_chips in range(1, N, partition_step):
            l_chips = N - e_chips
            e_combs = find_combs(e_chips, max_tp, max_pp=max_pp)
            if not e_combs:
                continue
            l_combs = find_combs(l_chips, max_tp, max_pp=max_pp)
            for ep in e_combs:
                for lp in l_combs:
                    for sched in partitioned:
                        if sched == "interleaved" and ep.pp + lp.pp < 2:
                            continue
                        yield ep, lp, sched
    if "encoder_fill" in schedules:
        for lp in find_combs(N, max_tp, max_pp=max_pp):
            if lp.pp < 2:        # no bubbles to fill — degenerate
                continue
            yield ModuleParallelism(lp.tp, 1, lp.dp), lp, "encoder_fill"
