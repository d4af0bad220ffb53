import importlib

from repro_torch.core.scheduler.lpt import lpt_schedule
from repro_torch.core.scheduler.ilp import BnBResult, solve_makespan_bnb
from repro_torch.core.scheduler.adaptive import AdaptiveCorrection

__all__ = [
    "lpt_schedule",
    "BnBResult",
    "solve_makespan_bnb",
    "OnlineMicrobatchScheduler",
    "ScheduleOutput",
    "AdaptiveCorrection",
]


def __getattr__(name):
    """The online scheduler loads torch (its spans), so it loads on first
    use: the search worker imports this package without torch."""
    if name in ("OnlineMicrobatchScheduler", "ScheduleOutput"):
        return getattr(importlib.import_module(f"{__name__}.online"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
