"""Device milliseconds a traced step in kernels that are neither the port's
K1-K7 nor cuBLAS GEMMs: PyTorch's own elementwise, reduction, copy and
optimizer kernels."""
from portbench import kernels


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["device_ops"]:
        return None
    ms = sum(b - a for name, a, b in tr["device_ops"]
             if kernels.port_kernel(name) is None and not kernels.is_gemm(name))
    return 1e3 * ms / len(tr["steps"])
