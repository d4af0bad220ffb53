"""Device milliseconds a traced step in the program's ``layer.mamba`` spans
(each Mamba mixer of the forward and of its recompute in the backward), by
the CUDA events at their edges (``fwd_ms``); None where the program records
no such span."""
from portbench.metrics.fwd_ms import per_step


def read(rec):
    return per_step(rec, "layer.mamba", "device_ms")
