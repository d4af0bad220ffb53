"""Work counts for the kernels: operations (copied from the reference's
kernels/bench.py, and what the WKV recurrence itself needs) and the bytes
each scan kernel must move."""
from __future__ import annotations


def attention_flops(B: int, H: int, S: int, D: int, *, causal: bool) -> float:
    """score + AV matmuls: 2·2·B·S·S·H·D, halved under causal masking."""
    f = 4.0 * B * S * S * H * D
    return f * 0.5 if causal else f


def mamba_flops(B: int, S: int, di: int, N: int) -> float:
    """Selective-scan term of ``flops._mamba_layer``: 6·B·S·di·N."""
    return 6.0 * B * S * di * N


def rwkv6_flops(B: int, H: int, S: int, M: int) -> float:
    """WKV recurrence term of ``flops._rwkv_layer`` with d = H·M:
    6·B·S·(H·M)·M."""
    return 6.0 * B * S * H * M * M


# The operations the WKV recurrence needs, per state element (i, j) and step
# (an FMA counts 2); the u-term and the dot products over v are O(M) per step.
# The reference's 6 per element (``rwkv6_flops``) is a profiler's estimate and
# over-counts the forward.
def rwkv6_fwd_ops(B: int, H: int, S: int, M: int) -> float:
    """K6: k_i·v_j (1), S_ij ← w_i·S_ij + kv_ij (2), y_j += r_i·S_ij (2)."""
    return 5.0 * B * H * S * M * M


def rwkv6_bwd_ops(B: int, H: int, S: int, M: int) -> float:
    """K7: the adjoint G_ij ← w_i·G_ij + r_i·ŷ_j (3) and the four contractions
    dw_i = Σ_j G_ij·S_ij, dk_i = Σ_j G_ij·v_j, dr_i = Σ_j S_ij·ŷ_j,
    dv_j = Σ_i G_ij·k_i (2 each).  Replaying the states from the
    chunk-initial ones is the kernel's own cost, not the function's."""
    return 11.0 * B * H * S * M * M


# Bytes each scan kernel must move: every input read once, every output
# written once.  ``e`` is the byte size of the sequence type (2 for bf16,
# 4 for f32); parameters, states and gradients are f32.  Only the function's
# own inputs and outputs count: the chunk-initial states the forward saves
# for the backward are a residual whose size the chunk sets, and cross-block
# partials are counted at their reduced size.
def mamba_fwd_bytes(B: int, S: int, di: int, N: int, e: int) -> float:
    """K4: u, dt, B_t, C_t, A, D in; y out."""
    return e * (3 * B * S * di + 2 * B * S * N) + 4 * (di * N + di)


def mamba_bwd_bytes(B: int, S: int, di: int, N: int, e: int) -> float:
    """K5: u, dt, B_t, C_t, A, D, dy in; du, ddt, dB, dC, dA, dD (f32) out."""
    return (e * (3 * B * S * di + 2 * B * S * N) + 4 * (di * N + di)
            + 4 * (2 * B * S * di + 2 * B * S * N + di * N + di))


def rwkv6_fwd_bytes(B: int, H: int, S: int, M: int, e: int) -> float:
    """K6: r, k, v (e), w, u (f32) in; y (e), final state (f32) out."""
    return e * 4 * B * H * S * M + 4 * (B * H * S * M + H * M + B * H * M * M)


def rwkv6_bwd_bytes(B: int, H: int, S: int, M: int, e: int) -> float:
    """K7: r, k, v, dy (e), w, u, ds (f32) in; dr, dk, dv, dw, du (f32) out."""
    return (e * 4 * B * H * S * M + 4 * (B * H * S * M + H * M + B * H * M * M)
            + 4 * (4 * B * H * S * M + H * M))
