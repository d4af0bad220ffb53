"""Roofline-calibrated analytic backend for the Model Profiler.

The numbers that feed the profiling grids come from a hardware model of the
card, not from timers: ``H100`` prices the port's card (one H100 SXM, its
datasheet rates), and the engine profiles with it unless the caller passes
another backend.  ``V5E`` and ``A100`` are the reference's specs, kept so
that the port's plans can be held against the reference's bit for bit.

The model reproduces the qualitative behaviour the paper measures in Fig. 2:
throughput degrades with TP degree when per-chip workload fragments become
too small (under-utilized matrix units) and from synchronization
collectives.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.common.types import ModelConfig
from repro_torch.core.profiling.flops import FlopCount, module_flops


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per link
    ici_latency: float = 2e-6         # per-collective latency (s)
    mem_bytes: float = 16e9           # HBM per chip
    chips_per_node: int = 16          # TP domain (mesh "model" axis)
    base_mxu_util: float = 0.6
    bytes_per_param: int = 2          # bf16 weights
    bytes_per_act: int = 2


V5E = HardwareSpec()
# A100-like spec for reproducing the paper's own Fig. 2 curves
A100 = HardwareSpec(name="a100", peak_flops=312e12, hbm_bw=2039e9,
                    ici_bw=300e9, mem_bytes=80e9, chips_per_node=8)
# The port's card, from the H100 SXM datasheet: dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s, 80 GB, 8 cards a node joined by NVLink 4 (bytes/s one way).
# ici_latency and base_mxu_util keep the defaults above: neither was
# measured on the card.
H100 = HardwareSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    ici_bw=450e9, mem_bytes=80e9, chips_per_node=8)


class AnalyticBackend:
    """Produces FLOP/s throughputs and byte footprints for profiler grids."""

    def __init__(self, hw: HardwareSpec = V5E):
        self.hw = hw

    # ----------------------------------------------------------------- #
    def _util(self, cfg: ModelConfig, tokens: float, tp: int) -> float:
        """MXU utilization: shrinks when per-chip fragments get small."""
        hw = self.hw
        f_tokens = min(1.0, tokens / 1024.0)             # M-dim occupancy
        width = max(cfg.d_ff, cfg.n_heads * max(cfg.head_dim, 1)) / max(tp, 1)
        f_width = min(1.0, width / 512.0)                # N-dim occupancy
        return hw.base_mxu_util * max(0.05, f_tokens) * max(0.1, f_width)

    def _collective_time(self, cfg: ModelConfig, tokens: float, tp: int) -> float:
        """Megatron-style TP sync: ~4 all-reduces of activations per layer."""
        if tp <= 1:
            return 0.0
        bytes_act = tokens * cfg.d_model * self.hw.bytes_per_act
        per_ar = 2.0 * bytes_act * (tp - 1) / tp / self.hw.ici_bw \
            + self.hw.ici_latency          # fixed launch/sync latency: this
        # is what makes small effective batches scale worse with TP (Fig. 2)
        return 4.0 * cfg.n_layers * per_ar

    def _step_time(self, cfg: ModelConfig, fl: float, tokens: float,
                   tp: int, mem_bound_bytes: float) -> float:
        compute = fl / tp / (self.hw.peak_flops * self._util(cfg, tokens, tp))
        memory = mem_bound_bytes / tp / self.hw.hbm_bw
        return max(compute, memory) + self._collective_time(cfg, tokens / max(tp, 1), tp)

    # ----------------------------------------------------------------- #
    def throughput(self, cfg: ModelConfig, batch: float, seq: float, tp: int,
                   *, split: str = "all", mode: str = "train") -> float:
        """Achieved FLOP/s (per TP group) for the given input shape."""
        fl = module_flops(cfg, batch, seq, mode=mode,
                          cache_len=seq if mode == "decode" else 0)
        part = {"attn": fl.attn, "lin": fl.lin, "all": fl.total}[split]
        if part <= 0:
            return self.hw.peak_flops  # degenerate; never dominates
        tokens = batch * (1 if mode == "decode" else seq)
        params_bytes = cfg.param_count() * self.hw.bytes_per_param
        act_bytes = tokens * cfg.d_model * cfg.n_layers * 4 * self.hw.bytes_per_act
        t_total = self._step_time(cfg, fl.total, tokens, tp,
                                  params_bytes + act_bytes)
        # attribute time to the split proportionally to its FLOP share,
        # with the recurrent/attention part additionally penalized at small
        # per-instance lengths (it cannot batch across instances).
        share = part / fl.total
        t_part = t_total * share
        return part / max(t_part, 1e-12)

    # ----------------------------------------------------------------- #
    def memory(self, cfg: ModelConfig, n_layers: int, tp: int, batch: float,
               seq: float) -> tuple[float, float]:
        """(model_state_bytes, act_state_bytes) per chip for n_layers."""
        import dataclasses

        sub = dataclasses.replace(cfg, n_layers=max(1, int(n_layers)),
                                  layer_pattern=cfg.layer_pattern[:1],
                                  ffn_pattern=cfg.ffn_pattern[:1])
        params = sub.param_count()
        # params(bf16) + grads(fp32) + adam m,v(fp32) + fp32 master
        model_state = params / tp * (2 + 4 + 4 + 4 + 4)
        tokens = batch * seq
        # remat: keep layer-boundary activations + one layer's working set
        boundary = tokens * cfg.d_model * self.hw.bytes_per_act * n_layers
        working = tokens * (cfg.d_model * 6 + cfg.d_ff / max(tp, 1) * 3) \
            * self.hw.bytes_per_act
        return model_state, boundary + working
