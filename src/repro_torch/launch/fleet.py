"""Elastic multi-host execution: fleet membership over the ranks of a
process group.

A "device" is a rank of the initialised ``torch.distributed`` process group
(one process a card under NCCL, or one a CPU core under gloo, as the tests
run it); a host is a contiguous group of ``devices_per_host`` ranks.  A host
that is *down* keeps its processes: they take part in the collectives that
a roster change needs (mesh bring-up, the state's migration) and train
nothing.  Three pieces:

  * ``FleetManager`` — owns the host roster and the mesh bring-up over it:
    ``plan_mesh(plan)`` builds a `ParallelismPlan`'s ``(data, stage,
    model)`` mesh over the *alive* ranks (exact when the roster has
    capacity, divisor-aware clamp otherwise — see `fleet_plan_mesh`), and
    ``cluster_spec()`` derives the roster-aware `ClusterSpec` the
    parallelism search re-plans against after a membership change.
    ``join`` / ``leave`` / ``fail`` mutate the roster and queue
    `MembershipEvent`s for the controller (`RuntimeController.poll_fleet`)
    to drain at the next global-batch boundary.
  * ``fleet_plan_mesh`` — the roster-aware mesh factory.  Unlike
    `clamped_plan_mesh`'s ``min()`` clamp, each axis is cut to its largest
    *divisor* that fits, so a stage axis always divides the restacked
    leading dim of stage-stacked params — routing reshards through the
    fleet never silently replicates a pytree a narrower-but-divisible
    stage axis could shard.
  * ``FaultInjector`` — the test hook: a deterministic
    ``{step: [(action, host_id), ...]}`` schedule applied by the training
    loop (``on_step(k)``), so kill/revive sequences are reproducible and
    the tests can pin recovery invariants (bit-identical
    `pipeline_forward` outputs across roster transitions, exactly-once
    data delivery, checkpoint-free resume).

Recovery itself lives in `repro_torch.runtime.controller`: on membership
events the controller re-runs the parallelism search for the new roster's
chip count, reshards the live (params, opt) state through the
`repro_torch.launch.reshard.ParamSwapper` path onto `FleetManager.plan_mesh`,
and resumes without a checkpoint; a failed reshard or an infeasible search
degrades to the surviving roster instead of crashing.

Every rank keeps its own `FleetManager` and applies the same schedule, so
the rosters (and the meshes built over them) agree; building a mesh is a
collective, which every rank of the group calls with the same plan.
Roster-only uses (the tests of the lifecycle) may pass opaque labels as
``devices`` and never build a mesh.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.optimizer.space import ClusterSpec, ParallelismPlan

# Membership event kinds: "leave" is a graceful departure (drained at a
# batch boundary), "fail" a crash (the in-flight step must be aborted and
# its data shards requeued — repro_torch.data.host_shard), "join" a
# (re)arrival.
EVENT_KINDS = ("join", "leave", "fail")


@dataclass
class FleetHost:
    """One host: a contiguous slice of the group's ranks."""

    host_id: int
    devices: tuple
    alive: bool = True


@dataclass(frozen=True)
class MembershipEvent:
    """One roster transition, queued for the controller to drain."""

    kind: str                   # "join" | "leave" | "fail"
    host_id: int
    step: int = -1              # training step the event fired at (-1: n/a)
    n_alive_after: int = 0      # hosts alive once the event applied


def largest_divisor_leq(n: int, limit: int) -> int:
    """Largest divisor of ``n`` that is <= ``limit`` (>= 1).

    >>> largest_divisor_leq(8, 5)
    4
    >>> largest_divisor_leq(6, 4)
    3
    >>> largest_divisor_leq(7, 3)
    1
    """
    for d in range(min(int(n), max(int(limit), 1)), 1, -1):
        if n % d == 0:
            return d
    return 1


def fleet_plan_mesh(plan: ParallelismPlan, devices: Sequence,
                    device_type: str = "cuda"):
    """Plan-implied mesh over a host roster's ranks.

    Exact ``(dp, pp, tp)`` over the first ``plan.llm.chips`` ranks when
    the roster has capacity; otherwise every axis is clamped to its
    largest *divisor* that fits (tp first, then pp, then dp).  The divisor
    constraint is the point: `clamped_plan_mesh`'s ``min()`` clamp can
    produce a stage axis that does not divide the plan's PP (pp=4 on 3
    ranks -> stage 3), which forces `reshard_params` to replicate
    stage-stacked leaves — a 2-wide stage axis would have sharded them.
    Routing mesh bring-up through the fleet keeps stage sharding whenever
    *any* divisor of PP fits the surviving roster.
    """
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("fleet mesh over an empty roster")
    # local import: reshard imports space/executor, not the other way round
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.reshard import PLAN_AXES

    mp = plan.llm
    if mp.chips <= n:
        return make_mesh((mp.dp, mp.pp, mp.tp), PLAN_AXES,
                         ranks=devices[:mp.chips], device_type=device_type)
    tp = largest_divisor_leq(mp.tp, n)
    pp = largest_divisor_leq(mp.pp, max(n // tp, 1))
    dp = largest_divisor_leq(mp.dp, max(n // (tp * pp), 1))
    return make_mesh((dp, pp, tp), PLAN_AXES, ranks=devices[:dp * pp * tp],
                     device_type=device_type)


class FleetManager:
    """Host roster + mesh bring-up over the ranks of a process group.

    >>> fm = FleetManager(devices=list("abcdefgh"), devices_per_host=2)
    >>> fm.n_hosts, fm.n_alive, fm.n_chips
    (4, 4, 8)
    >>> _ = fm.fail(1, step=3)
    >>> fm.n_chips, [h.host_id for h in fm.alive]
    (6, [0, 2, 3])
    >>> fm.devices()
    ['a', 'b', 'e', 'f', 'g', 'h']
    >>> [ev.kind for ev in fm.poll_events()]
    ['fail']
    >>> _ = fm.join(1)
    >>> fm.n_chips
    8
    """

    def __init__(self, devices: Optional[Sequence] = None, *,
                 devices_per_host: int = 1,
                 n_hosts: Optional[int] = None,
                 device_type: str = "cuda"):
        """``devices`` default to the ranks of the initialised process
        group (raising without one); ``device_type`` is the meshes' ("cuda"
        under NCCL, "cpu" under gloo)."""
        if devices is None:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "FleetManager's devices are the ranks of the process group: "
                    "initialise one (torch.distributed.init_process_group) or "
                    "pass devices=")
            devices = range(dist.get_world_size())
        devices = list(devices)
        if n_hosts is not None:
            if n_hosts < 1 or len(devices) % n_hosts:
                raise ValueError(
                    f"{len(devices)} devices do not split into "
                    f"{n_hosts} equal hosts")
            devices_per_host = len(devices) // n_hosts
        from repro_torch.launch.mesh import host_groups
        self.devices_per_host = devices_per_host
        self.device_type = device_type
        self.hosts: List[FleetHost] = [
            FleetHost(i, tuple(group))
            for i, group in enumerate(host_groups(devices, devices_per_host))]
        self._events: Deque[MembershipEvent] = deque()
        self.history: List[MembershipEvent] = []

    # ------------------------------------------------------------------ #
    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def alive(self) -> List[FleetHost]:
        return [h for h in self.hosts if h.alive]

    @property
    def n_alive(self) -> int:
        return len(self.alive)

    def alive_ids(self) -> List[int]:
        return [h.host_id for h in self.alive]

    def devices(self) -> list:
        """Ranks of the alive hosts, in host order — the roster every
        mesh is brought up over."""
        return [d for h in self.alive for d in h.devices]

    @property
    def n_chips(self) -> int:
        return len(self.devices())

    def host(self, host_id: int) -> FleetHost:
        for h in self.hosts:
            if h.host_id == host_id:
                return h
        raise KeyError(f"no host {host_id} in the fleet")

    def host_of(self, device) -> FleetHost:
        """The host a rank belongs to."""
        for h in self.hosts:
            if device in h.devices:
                return h
        raise KeyError(f"no host holds {device!r}")

    # ------------------------------------------------------------------ #
    def _transition(self, kind: str, host_id: int, step: int,
                    alive: bool) -> MembershipEvent:
        h = self.host(host_id)
        if h.alive == alive:
            state = "alive" if alive else "down"
            raise ValueError(f"host {host_id} is already {state}")
        h.alive = alive
        ev = MembershipEvent(kind, host_id, step, self.n_alive)
        self._events.append(ev)
        self.history.append(ev)
        return ev

    def leave(self, host_id: int, step: int = -1) -> MembershipEvent:
        """Graceful departure (the host drains at a batch boundary)."""
        return self._transition("leave", host_id, step, alive=False)

    def fail(self, host_id: int, step: int = -1) -> MembershipEvent:
        """Crash: the roster effect of `leave`, but consumers must treat
        the in-flight step as lost (abort + requeue its data shards)."""
        return self._transition("fail", host_id, step, alive=False)

    def join(self, host_id: int, step: int = -1) -> MembershipEvent:
        """(Re)arrival of a down host."""
        return self._transition("join", host_id, step, alive=True)

    def poll_events(self) -> List[MembershipEvent]:
        """Drain queued membership events (controller: once per batch
        boundary).  ``history`` keeps the full record."""
        out = list(self._events)
        self._events.clear()
        return out

    # ------------------------------------------------------------------ #
    def plan_mesh(self, plan: ParallelismPlan):
        """Mesh bring-up over the alive roster (`fleet_plan_mesh`).  Pass
        as ``ParamSwapper(mesh_factory=fleet.plan_mesh)`` so physical
        reshards always target the surviving ranks."""
        return fleet_plan_mesh(plan, self.devices(), self.device_type)

    def cluster_spec(self, template: Optional[ClusterSpec] = None) -> ClusterSpec:
        """Roster-aware `ClusterSpec`: ``n_chips`` tracks the alive
        ranks, ``chips_per_node`` the per-host TP domain.  ``template``
        (e.g. the engine's H100 cluster) supplies memory and naming."""
        if template is not None:
            return replace(template, n_chips=self.n_chips,
                           chips_per_node=min(template.chips_per_node,
                                              max(self.devices_per_host, 1)))
        return ClusterSpec(n_chips=self.n_chips,
                           chips_per_node=self.devices_per_host,
                           name="emulated-fleet")

    def partition_items(self, items: Sequence) -> Dict[int, list]:
        """Per-host data shard of one global batch (round-robin over the
        alive roster; `repro_torch.data.host_shard.partition_by_host`)."""
        from repro_torch.data.host_shard import partition_by_host
        return partition_by_host(items, self.alive_ids())


class FaultInjector:
    """Deterministic kill/revive schedule driven by the training loop.

    ``schedule`` maps a step index to the membership actions fired when
    the loop reaches it: ``{6: [("fail", 3)], 12: [("join", 3)]}``.
    The loop calls ``on_step(k)`` once per step *before* drawing data, so
    a killed host's shard is requeued before the next draw partitions
    over the survivors.

    >>> fm = FleetManager(devices=list("abcd"), devices_per_host=1)
    >>> inj = FaultInjector(fm, {2: [("fail", 0)], 5: [("join", 0)]})
    >>> [len(inj.on_step(k)) for k in range(6)]
    [0, 0, 1, 0, 0, 1]
    >>> [ev.kind for ev in inj.fired]
    ['fail', 'join']
    """

    def __init__(self, fleet: FleetManager,
                 schedule: Dict[int, List[Tuple[str, int]]]):
        for step, actions in schedule.items():
            for action, _host in actions:
                if action not in EVENT_KINDS:
                    raise ValueError(f"unknown action {action!r} at step "
                                     f"{step}; expected one of {EVENT_KINDS}")
        self.fleet = fleet
        self.schedule = {int(k): list(v) for k, v in schedule.items()}
        self.fired: List[MembershipEvent] = []

    def on_step(self, step: int) -> List[MembershipEvent]:
        evs = [getattr(self.fleet, action)(host_id, step=step)
               for action, host_id in self.schedule.get(int(step), [])]
        self.fired.extend(evs)
        return evs
