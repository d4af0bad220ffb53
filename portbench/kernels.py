"""Which device kernels of a profiler trace are whose: the port's
hand-written kernels K1-K7 (``src/repro_torch/kernels/csrc/*.cu``) by
their names, and cuBLAS's matrix products by the names its GEMM kernels
carry on the H100 (``nvjet``, ``xmma``/``gemm``, CUTLASS, the split-K
reduction)."""
from __future__ import annotations

import re

# K1-K3 (packed_flash_attention.cu): tensor-core bf16 and CUDA-core fp32
ATTENTION = {
    "K1": re.compile(r"\bfwd_tc_kernel\b|\bfwd_kernel<\d+>"),
    "K2": re.compile(r"\bbwd_dq_tc_kernel\b|\bbwd_dq_kernel<\d+>"),
    "K3": re.compile(r"\bbwd_dkv_tc_kernel\b|\bbwd_dkv_kernel<\d+[,>]"),
}
# K4-K7 (mamba_scan.cu, rwkv6_scan.cu)
SCANS = {
    "K4": re.compile(r"\bfwd_kernel<(__nv_bfloat16|float), "),
    "K5": re.compile(r"\bbwd_kernel<(__nv_bfloat16|float), "),
    "K6": re.compile(r"\bwkv6_fwd_kernel\b"),
    "K7": re.compile(r"\bwkv6_bwd_kernel\b"),
}
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|splitKreduce", re.IGNORECASE)


def port_kernel(name: str) -> str | None:
    """'K1'..'K7' for a kernel of the port's own, else None."""
    for k, rx in {**ATTENTION, **SCANS}.items():
        if rx.search(name):
            return k
    return None


def is_gemm(name: str) -> bool:
    return port_kernel(name) is None and bool(GEMM.search(name))
