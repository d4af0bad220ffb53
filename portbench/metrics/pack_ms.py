"""Host milliseconds a traced step in the program's ``loader.pack`` span:
``ScheduledLoader`` packing the step's items into its rows on the caller's
thread (``fwd_ms`` reads the recorder)."""
from portbench.metrics.fwd_ms import per_step


def read(rec):
    ms = per_step(rec, "loader.pack", "dur_us")
    return ms / 1e3 if ms is not None else None
