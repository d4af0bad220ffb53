"""Host milliseconds a window step waits for its batch: the benchmark's own
span around ``next(loader)`` (scheduling, packing), mean over the steps."""


def read(rec):
    steps = rec["window"]["steps"]
    return 1e3 * sum(s["wait_s"] for s in steps) / len(steps) if steps else None
