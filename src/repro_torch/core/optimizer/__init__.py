from repro_torch.core.optimizer.space import (
    SCHEDULES,
    VIRTUAL_CHUNKS,
    ClusterSpec,
    ModuleParallelism,
    ParallelismPlan,
    find_combs,
    enumerate_configs,
)
from repro_torch.core.optimizer.objective import (
    BalancedQuantileObjective,
    ExpectedRandomObjective,
    MeanObjective,
    Objective,
    ObjectiveResult,
    OBJECTIVE_NAMES,
    get_objective,
)
from repro_torch.core.optimizer.search import ParallelismOptimizer, SearchResult

__all__ = [
    "SCHEDULES",
    "VIRTUAL_CHUNKS",
    "ClusterSpec",
    "ModuleParallelism",
    "ParallelismPlan",
    "find_combs",
    "enumerate_configs",
    "ParallelismOptimizer",
    "SearchResult",
    "Objective",
    "ObjectiveResult",
    "MeanObjective",
    "ExpectedRandomObjective",
    "BalancedQuantileObjective",
    "get_objective",
    "OBJECTIVE_NAMES",
]
