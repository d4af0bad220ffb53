"""The least time K4 and K5 (the port's selective scan, ``mamba_scan.cu``)
could take on one launch: max(operations at the H100's fp32 peak, bytes at
its HBM rate).  Frozen arithmetic, as ``formulas.py``'s.

Operations: the selective scan's 6·B·S·di·N a forward (``bench.mamba_flops``,
the reference's count), twice that for the backward.  Bytes: what the scan
itself needs, each read once and each written once.  The forward reads u,
dt (B, S, di) and B_t, C_t (B, S, N) in the compute type, A (di, N) and D
(di,) in fp32 and the restart words, and writes y (B, S, di).  The backward
reads those inputs and dy (B, S, di), and writes the gradients in the types
the scan returns them: du, ddt, dB_t, dC_t in the compute type, dA and dD
in fp32.  The port's own buffers are left out of the bound:
``design_bytes`` counts them (K4's fp32 chunk-initial states, which K5
reads back; K5's fp32 du, ddt and its per-row dA, dD and per-channel-block
dB, dC partials, which the autograd Function reduces and casts).
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12          # H100 SXM, dense fp32 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
CHUNK = 16                       # K4's chunk (the states it saves for K5)
C_BLK = 128                      # channels of a K5 block (its dB/dC partials)


def scan_bytes(B: int, S: int, di: int, N: int, elem_bytes: int = 2) -> dict[str, int]:
    """{'K4': bytes, 'K5': bytes}: what the forward and the backward of the
    scan read and write at the least."""
    seq, bc = B * S * di * elem_bytes, B * S * N * elem_bytes
    small = di * N * 4 + di * 4 + B * -(-S // 32) * 4            # A, D, restart words
    k4 = 2 * seq + 2 * bc + small + seq
    k5 = 3 * seq + 2 * bc + small + 2 * seq + 2 * bc + di * N * 4 + di * 4
    return {"K4": k4, "K5": k5}


def design_bytes(B: int, S: int, di: int, N: int, chunk: int = CHUNK) -> dict[str, int]:
    """{'K4': bytes, 'K5': bytes}: the traffic of the port's own buffers on
    top of ``scan_bytes``: K4 writes and K5 reads the fp32 chunk-initial
    states; K5 writes du, ddt in fp32 and per-row dA, dD and per-block dB,
    dC partials."""
    states = B * -(-S // chunk) * di * N * 4
    n_cblk = -(-di // C_BLK)
    return {"K4": states,
            "K5": states + 2 * B * S * di * 4 + B * di * N * 4 + B * di * 4
            + 2 * n_cblk * B * S * N * 4}


def scan_bounds(B: int, S: int, di: int, N: int, elem_bytes: int = 2) -> dict[str, float]:
    """{'K4': s, 'K5': s}: the least seconds of one launch of each."""
    ops = 6.0 * B * S * di * N
    nbytes = scan_bytes(B, S, di, N, elem_bytes)
    return {"K4": max(ops / PEAK_FP32_FLOPS, nbytes["K4"] / HBM_BYTES_PER_S),
            "K5": max(2 * ops / PEAK_FP32_FLOPS, nbytes["K5"] / HBM_BYTES_PER_S)}
