"""Host milliseconds a traced step in the program's ``sched.schedule``
spans: the Online Microbatch Scheduler's search for the next global batch,
on its worker thread while the step runs (those that began while the
traced steps ran; ``fwd_ms`` reads the recorder)."""
from portbench.metrics.fwd_ms import per_step


def read(rec):
    ms = per_step(rec, "sched.schedule", "dur_us")
    return ms / 1e3 if ms is not None else None
