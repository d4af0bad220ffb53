"""Model Profiler (§3.2.1): grid measurement -> interpolated perf models.

Builds, for the modality encoder,
    E_thr(E_batch_size, E_tp)                       [FLOP/s]
and for the LLM (sequence-packed, effective batch 1),
    L_attn_thr(L_seq_len, L_tp), L_lin_thr(L_seq_len, L_tp)
plus memory models
    model_state(l, tp)   and   act_state(l, tp, batch_or_seq)
by measuring a backend on a sparse grid and interpolating (paper: "varying
the number of layers between two distinct small values and scaling the TP
degree in powers of two up to N_gpu_node").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence

import numpy as np

from repro_torch.common.types import ModelConfig
from repro_torch.core.profiling.flops import FlopCount, module_flops
from repro_torch.core.profiling.interpolation import GridInterpolator


class Backend(Protocol):
    def throughput(self, cfg: ModelConfig, batch: float, seq: float, tp: int,
                   *, split: str = "all", mode: str = "train") -> float: ...

    def memory(self, cfg: ModelConfig, n_layers: int, tp: int, batch: float,
               seq: float) -> tuple[float, float]: ...


@dataclass
class ThroughputModel:
    """FLOP/s as a function of (shape, tp); shape is batch (encoder) or
    seq len (LLM)."""

    grid: GridInterpolator

    def __call__(self, shape: float, tp: float) -> float:
        return max(self.grid(shape, tp), 1e3)

    def batch(self, shapes: np.ndarray, tp: float) -> np.ndarray:
        pts = np.stack([shapes, np.full_like(shapes, tp, dtype=np.float64)], 1)
        return np.maximum(self.grid.batch(pts), 1e3)


@dataclass
class MemoryModel:
    """Eq. 4/5 building blocks: model_state(l, tp), act_state(l, tp, x)."""

    model_state_grid: GridInterpolator      # (layers, tp) -> bytes
    act_state_grid: GridInterpolator        # (layers, tp, shape) -> bytes

    def model_state(self, n_layers: float, tp: float) -> float:
        return self.model_state_grid(n_layers, tp)

    def act_state(self, n_layers: float, tp: float, shape: float) -> float:
        return self.act_state_grid(n_layers, tp, shape)


@dataclass
class ModulePerf:
    cfg: ModelConfig
    thr_all: ThroughputModel
    thr_attn: Optional[ThroughputModel]
    thr_lin: Optional[ThroughputModel]
    memory: MemoryModel
    fixed_seq: float = 0.0   # encoder: E_seq_len (tokens per media item)

    # -- durations (paper §3.3.1): dur = FLOP / thr ---------------------- #
    def flops(self, batch: float, seq: float, mode: str = "train") -> FlopCount:
        return module_flops(self.cfg, batch, seq, mode=mode)

    def duration(self, batch: float, seq: float, tp: int,
                 mode: str = "train") -> float:
        fl = self.flops(batch, seq, mode)
        if self.thr_attn is not None and self.thr_lin is not None:
            shape = seq if self.fixed_seq == 0 else batch
            t = fl.attn / self.thr_attn(shape, tp) + \
                fl.lin / self.thr_lin(shape, tp)
            return t
        shape = seq if self.fixed_seq == 0 else batch
        return fl.total / self.thr_all(shape, tp)

    def duration_batch(self, shapes: np.ndarray, tp: int,
                       mode: str = "train") -> np.ndarray:
        """Vectorized `duration` over many shapes (encoder: effective batch;
        LLM: packed seq len).  FLOPs come from the attn/lin polynomial —
        attn(s) = a1·s + a2·s², lin(s) = b1·s — exactly the construction the
        optimizer's `_ModuleTables` uses, so table entries and per-item
        Monte-Carlo durations are the same computation.  Non-positive
        shapes map to duration 0."""
        shapes = np.asarray(shapes, dtype=np.float64)
        out = np.zeros_like(shapes)
        pos = shapes > 0
        if not pos.any():
            return out
        s = shapes[pos]
        if self.fixed_seq:
            # encoder: FLOPs linear in the effective batch at fixed seq
            per = module_flops(self.cfg, 1.0, self.fixed_seq, mode=mode)
            fl_attn = per.attn * s
            fl_lin = per.lin * s
        else:
            f1 = module_flops(self.cfg, 1.0, 1.0, mode=mode)
            f2 = module_flops(self.cfg, 1.0, 2.0, mode=mode)
            a2 = (f2.attn - 2 * f1.attn) / 2.0
            a1 = f1.attn - a2
            if self.cfg.attention_kind == "sliding" and self.cfg.window_size:
                # piecewise: quadratic until W, then linear — evaluate exact
                fl_attn = np.array([module_flops(self.cfg, 1.0, v,
                                                 mode=mode).attn for v in s])
            else:
                fl_attn = a1 * s + a2 * s ** 2
            fl_lin = f1.lin * s
        if self.thr_attn is not None and self.thr_lin is not None:
            dur = fl_attn / self.thr_attn.batch(s, tp) \
                + fl_lin / self.thr_lin.batch(s, tp)
        else:
            dur = (fl_attn + fl_lin) / self.thr_all.batch(s, tp)
        out[pos] = dur
        return out


@dataclass
class PerfModel:
    """Everything the optimizer and scheduler need (profiling output)."""

    encoder: Optional[ModulePerf]
    llm: ModulePerf

    def e_dur(self, eff_batch: float, tp: int, mode: str = "train") -> float:
        """Duration for `eff_batch` media items on the encoder."""
        if self.encoder is None or eff_batch <= 0:
            return 0.0
        return self.encoder.duration(eff_batch, self.encoder.fixed_seq, tp, mode)

    def l_dur(self, seq_len: float, tp: int, mode: str = "train") -> float:
        """Duration for a packed sequence of `seq_len` tokens on the LLM."""
        if seq_len <= 0:
            return 0.0
        return self.llm.duration(1.0, seq_len, tp, mode)

    def e_dur_batch(self, eff_batches: np.ndarray, tp: int,
                    mode: str = "train") -> np.ndarray:
        if self.encoder is None:
            return np.zeros_like(np.asarray(eff_batches, dtype=np.float64))
        return self.encoder.duration_batch(eff_batches, tp, mode)

    def l_dur_batch(self, seq_lens: np.ndarray, tp: int,
                    mode: str = "train") -> np.ndarray:
        return self.llm.duration_batch(seq_lens, tp, mode)


DEFAULT_TPS = (1, 2, 4, 8, 16)


class ModelProfiler:
    """Profiles a module on a (shape x tp) grid via a Backend."""

    def __init__(self, backend: Backend, *,
                 tp_degrees: Sequence[int] = DEFAULT_TPS,
                 shape_grid: Sequence[float] = (1, 2, 4, 8, 16, 32, 64),
                 layer_grid: Sequence[int] = (2, 4),
                 mode: str = "train"):
        self.backend = backend
        self.tp_degrees = tuple(sorted(tp_degrees))
        self.shape_grid = tuple(sorted(shape_grid))
        self.layer_grid = tuple(sorted(layer_grid))
        self.mode = mode

    # ------------------------------------------------------------------ #
    def _thr_grid(self, cfg: ModelConfig, split: str, *,
                  batch_of=None, seq_of=None) -> ThroughputModel:
        vals = np.zeros((len(self.shape_grid), len(self.tp_degrees)))
        for i, s in enumerate(self.shape_grid):
            for j, tp in enumerate(self.tp_degrees):
                vals[i, j] = self.backend.throughput(
                    cfg, batch_of(s), seq_of(s), tp, split=split,
                    mode=self.mode)
        return ThroughputModel(GridInterpolator(
            [np.array(self.shape_grid, float),
             np.array(self.tp_degrees, float)], vals))

    def _memory_model(self, cfg: ModelConfig, *, batch_of, seq_of) -> MemoryModel:
        L, T, S = self.layer_grid, self.tp_degrees, self.shape_grid
        ms = np.zeros((len(L), len(T)))
        act = np.zeros((len(L), len(T), len(S)))
        for i, l in enumerate(L):
            for j, tp in enumerate(T):
                for k, s in enumerate(S):
                    m, a = self.backend.memory(cfg, l, tp, batch_of(s), seq_of(s))
                    act[i, j, k] = a
                ms[i, j] = m
        return MemoryModel(
            GridInterpolator([np.array(L, float), np.array(T, float)], ms),
            GridInterpolator([np.array(L, float), np.array(T, float),
                              np.array(S, float)], act))

    # ------------------------------------------------------------------ #
    def profile_encoder(self, cfg: ModelConfig, e_seq_len: int) -> ModulePerf:
        """Encoder: variable effective batch, fixed per-item seq len."""
        batch_of = lambda s: float(s)
        seq_of = lambda s: float(e_seq_len)
        return ModulePerf(
            cfg=cfg,
            thr_all=self._thr_grid(cfg, "all", batch_of=batch_of, seq_of=seq_of),
            thr_attn=None, thr_lin=None,
            memory=self._memory_model(cfg, batch_of=batch_of, seq_of=seq_of),
            fixed_seq=float(e_seq_len))

    def profile_llm(self, cfg: ModelConfig,
                    seq_grid: Sequence[float] = (256, 512, 1024, 2048, 4096,
                                                 8192, 16384, 32768)) -> ModulePerf:
        """LLM: sequence packing -> batch 1, variable packed seq length."""
        prof = ModelProfiler(self.backend, tp_degrees=self.tp_degrees,
                             shape_grid=seq_grid, layer_grid=self.layer_grid,
                             mode=self.mode)
        batch_of = lambda s: 1.0
        seq_of = lambda s: float(s)
        return ModulePerf(
            cfg=cfg,
            thr_all=prof._thr_grid(cfg, "all", batch_of=batch_of, seq_of=seq_of),
            thr_attn=prof._thr_grid(cfg, "attn", batch_of=batch_of, seq_of=seq_of),
            thr_lin=prof._thr_grid(cfg, "lin", batch_of=batch_of, seq_of=seq_of),
            memory=prof._memory_model(cfg, batch_of=batch_of, seq_of=seq_of),
            fixed_seq=0.0)

    def profile_mllm(self, enc_cfg: Optional[ModelConfig],
                     llm_cfg: ModelConfig, e_seq_len: int = 0) -> PerfModel:
        enc = self.profile_encoder(enc_cfg, e_seq_len) if enc_cfg else None
        return PerfModel(encoder=enc, llm=self.profile_llm(llm_cfg))
