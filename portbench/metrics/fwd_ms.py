"""Device milliseconds a traced step in the program's ``step.forward`` spans
(one a microbatch): the CUDA events the program records at each span's
edges on the step's stream, so the phase's device wall time, idle inside it
included.  Read from the process's recorder (``repro_torch.runtime.trace``),
which a profiler switches on for the traced steps; None where the program
records no such span."""


def program_spans(rec):
    """The program's spans of the traced steps, or None: those the profiler
    mirrored (the step's thread) and those of other threads (the scheduler's
    worker), which record while it is on."""
    if not rec.get("trace") or not rec["trace"]["steps"]:
        return None
    from repro_torch.runtime import trace
    recorder = getattr(trace, "recorder", None)
    if recorder is None:
        return None
    spans = recorder().spans()
    caller = {s["tid"] for s in spans if s.get("mirrored")}
    return [s for s in spans if s.get("mirrored") or s["tid"] not in caller] or None


def per_step(rec, name: str, key: str):
    """The traced steps' sum of ``key`` over spans named ``name``, a step."""
    spans = program_spans(rec)
    vals = [s[key] for s in spans or () if s["name"] == name and s[key] is not None]
    return sum(vals) / len(rec["trace"]["steps"]) if vals else None


def read(rec):
    return per_step(rec, "step.forward", "device_ms")
