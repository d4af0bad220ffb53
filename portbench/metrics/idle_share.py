"""Share of the traced span in which no operation ran on the device: one
minus the union of the device intervals over the span."""
from portbench import formulas


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["span"]:
        return None
    t0, t1 = tr["span"]
    busy = formulas.busy_union([(a, b) for _, a, b in tr["device_ops"]], t0, t1)
    return 100.0 * (1.0 - busy / (t1 - t0))
