"""Device milliseconds a traced step in K1-K3 (packed flash attention)."""
from portbench import kernels


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    ms = sum(b - a for name, a, b in tr["device_ops"]
             if kernels.port_kernel(name) in kernels.ATTENTION)
    return 1e3 * ms / len(tr["steps"]) if ms > 0 else None
