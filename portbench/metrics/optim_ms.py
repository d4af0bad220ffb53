"""Device milliseconds a traced step in the program's ``step.optimizer``
span (the gradients' division, ``global_norm``, clip and AdamW), by the
CUDA events at its edges (``fwd_ms``)."""
from portbench.metrics.fwd_ms import per_step


def read(rec):
    return per_step(rec, "step.optimizer", "device_ms")
