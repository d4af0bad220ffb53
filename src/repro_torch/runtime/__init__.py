"""repro_torch.runtime — telemetry & continuous re-planning (the port's copy).

Turns the one-shot profile → plan → schedule façade into a closed control
loop (the paper's "continuously profiles runtime behavior" claim):

  trace       — low-overhead span recorder, Chrome-trace (Perfetto) export
  metrics     — rolling bubble-fraction / utilization / imbalance counters
  calibration — online per-(module, shape-bucket, tp) EWMA residual model
  drift       — Page–Hinkley + KS drift detection over shapes & residuals
  controller  — RuntimeController: background re-plan + plan hot-swap

Entry point: ``DFLOPEngine.runtime(gbs)`` returns a wired controller.
"""
from repro_torch.runtime.calibration import OnlineCalibrator, shape_bucket
from repro_torch.runtime.controller import (
    RecoveryRecord,
    ReplanRecord,
    RuntimeController,
)
from repro_torch.runtime.drift import (
    DriftDetector,
    DriftEvent,
    PageHinkley,
    ks_distance,
)
from repro_torch.runtime.metrics import RollingStat, RuntimeMetrics
from repro_torch.runtime.trace import TraceRecorder

__all__ = [
    "DriftDetector",
    "DriftEvent",
    "OnlineCalibrator",
    "PageHinkley",
    "RecoveryRecord",
    "ReplanRecord",
    "RollingStat",
    "RuntimeController",
    "RuntimeMetrics",
    "TraceRecorder",
    "ks_distance",
    "shape_bucket",
]
