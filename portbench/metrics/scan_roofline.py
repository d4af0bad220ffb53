"""K4+K5's summed least time over their summed device time in the traced
steps.  Each launch scans one microbatch's rows whole (B rows of S steps at
the configuration's d_inner and d_state, in its compute type), so its least
time is ``scan_bounds.scan_bounds`` of that shape."""
import numpy as np

from portbench import kernels
from portbench.scan_bounds import scan_bounds


def read(rec):
    tr, m = rec["trace"], rec["dims"]
    if not tr or not hasattr(m, "d_inner"):
        return None
    spent, launches = {"K4": 0.0, "K5": 0.0}, {"K4": 0, "K5": 0}
    for name, a, b in tr["device_ops"]:
        k = kernels.port_kernel(name)
        if k in spent:
            spent[k] += b - a
            launches[k] += 1
    if sum(spent.values()) <= 0:
        return None
    shape = np.asarray(tr["steps"][0]["segment_ids"]).shape       # (n_mb, rows, S)
    bound = scan_bounds(shape[-2], shape[-1], m.d_inner, m.d_state,
                        2 if m.compute_dtype == "bfloat16" else 4)
    least = sum(launches[k] * bound[k] for k in spent)
    return 100.0 * least / sum(spent.values())
