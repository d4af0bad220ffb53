from repro_torch.core.scheduler.lpt import lpt_schedule
from repro_torch.core.scheduler.ilp import BnBResult, solve_makespan_bnb
from repro_torch.core.scheduler.online import OnlineMicrobatchScheduler, ScheduleOutput
from repro_torch.core.scheduler.adaptive import AdaptiveCorrection

__all__ = [
    "lpt_schedule",
    "BnBResult",
    "solve_makespan_bnb",
    "OnlineMicrobatchScheduler",
    "ScheduleOutput",
    "AdaptiveCorrection",
]
