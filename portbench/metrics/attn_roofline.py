"""K1+K2+K3's summed least time over their summed device time in the traced
steps.  Each launch's least time is ``formulas.attention_launch_bounds`` of
its row; the traced launches of each kernel are spread evenly over the
steps' rows (every row of a step runs the same layers)."""
import numpy as np

from portbench import formulas, kernels


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    spent = {k: 0.0 for k in kernels.ATTENTION}
    launches = dict.fromkeys(kernels.ATTENTION, 0)
    for name, a, b in tr["device_ops"]:
        k = kernels.port_kernel(name)
        if k in spent:
            spent[k] += b - a
            launches[k] += 1
    if sum(spent.values()) <= 0:
        return None
    rows = [r for s in tr["steps"] for r in np.asarray(s["segment_ids"]).reshape(
        -1, np.asarray(s["segment_ids"]).shape[-1])]
    bounds = [formulas.attention_launch_bounds(rec["dims"], r) for r in rows]
    least = sum(launches[k] / len(rows) * sum(b[k] for b in bounds) for k in spent)
    return 100.0 * least / sum(spent.values())
