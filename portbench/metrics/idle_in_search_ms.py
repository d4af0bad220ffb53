"""Device-idle milliseconds a traced step that overlap the scheduler's
search: the gaps between the traced device operations inside the traced
span, intersected with the program's ``sched.schedule`` spans (its worker
thread) put onto the profile's clock.  The offset is the median gap between
the program's mirrored spans and their ``repro_torch.<span>`` copies in the
profile's host operations (the same clock, a different origin)."""
import statistics

from portbench import formulas
from portbench.metrics.fwd_ms import program_spans


def mirror_gaps(spans, host_ops):
    """Each mirrored span against its ``repro_torch.<span>`` copy among the
    profile's host operations: (name, start gap, end gap), profile time minus
    recorder time in microseconds.  A name whose copies do not pair one to
    one with its spans is left out."""
    theirs = {}
    for name, a, b in host_ops:
        if name.startswith("repro_torch."):
            theirs.setdefault(name[len("repro_torch."):], []).append((a * 1e6, b * 1e6))
    ours = {}
    for s in spans:
        if s.get("mirrored"):
            ours.setdefault(s["name"], []).append(s)
    gaps = []
    for name, mine in ours.items():
        if len(theirs.get(name, ())) == len(mine):
            for (a, b), s in zip(sorted(theirs[name]), mine):
                gaps.append((name, a - s["ts_us"], b - s["ts_us"] - s["dur_us"]))
    return gaps


def offset_us(spans, host_ops):
    """Profile time minus recorder time, in microseconds, or None."""
    gaps = [d for _, a, b in mirror_gaps(spans, host_ops) for d in (a, b)]
    return statistics.median(gaps) if gaps else None


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["span"] or not tr["device_ops"]:
        return None
    spans = program_spans(rec)
    off = offset_us(spans, tr["host_ops"]) if spans else None
    if off is None:
        return None
    search = [((s["ts_us"] + off) / 1e6, (s["ts_us"] + s["dur_us"] + off) / 1e6)
              for s in spans if s["name"] == "sched.schedule"]
    if not search:
        return None
    gaps = formulas.idle_gaps([(a, b) for _, a, b in tr["device_ops"]], *tr["span"])
    idle = sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in search)
    return 1e3 * idle / len(tr["steps"])
