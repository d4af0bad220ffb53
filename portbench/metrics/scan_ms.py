"""Device milliseconds a traced step in K4 and K5 (the Mamba selective
scan's forward, with the recompute's, and backward)."""
from portbench import kernels

SCAN = ("K4", "K5")


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    ms = sum(b - a for name, a, b in tr["device_ops"] if kernels.port_kernel(name) in SCAN)
    return 1e3 * ms / len(tr["steps"]) if ms > 0 else None
