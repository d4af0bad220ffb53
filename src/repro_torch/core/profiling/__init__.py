from repro_torch.core.profiling.interpolation import GridInterpolator
from repro_torch.core.profiling.data_profiler import DataProfiler, ShapeDistribution
from repro_torch.core.profiling.model_profiler import (
    ModelProfiler,
    PerfModel,
    ThroughputModel,
    MemoryModel,
)

__all__ = [
    "GridInterpolator",
    "DataProfiler",
    "ShapeDistribution",
    "ModelProfiler",
    "PerfModel",
    "ThroughputModel",
    "MemoryModel",
]
