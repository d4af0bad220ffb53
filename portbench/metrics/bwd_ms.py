"""Device milliseconds a traced step in the program's ``step.backward``
spans (one a microbatch: ``loss.backward()`` and the fp32 gradient sums),
by the CUDA events at their edges (``fwd_ms``)."""
from portbench.metrics.fwd_ms import per_step


def read(rec):
    return per_step(rec, "step.backward", "device_ms")
