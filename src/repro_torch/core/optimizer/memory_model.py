"""Memory feasibility (paper Eq. 4 / Eq. 5).

Encoder activations are retained for the *entire* pipeline lifetime, so
their cost scales with total depth (E_pp + L_pp); the LLM's activations
scale with its own depth only.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.optimizer.space import ModuleParallelism
from repro_torch.core.profiling.model_profiler import ModulePerf


def encoder_mem(perf_e: ModulePerf, ep: ModuleParallelism, l_pp: int,
                t_bsz: float) -> float:
    """Eq. 4: model_state(E_l/E_pp, E_tp) + (E_pp+L_pp)·act_state(...)."""
    layers = perf_e.cfg.n_layers / ep.pp
    ms = perf_e.memory.model_state(layers, ep.tp)
    act = perf_e.memory.act_state(layers, ep.tp, t_bsz)
    return ms + (ep.pp + l_pp) * act


def llm_mem(perf_l: ModulePerf, lp: ModuleParallelism, t_seq: float) -> float:
    """Eq. 5: model_state(L_l/L_pp, L_tp) + L_pp·act_state(...)."""
    layers = perf_l.cfg.n_layers / lp.pp
    ms = perf_l.memory.model_state(layers, lp.tp)
    act = perf_l.memory.act_state(layers, lp.tp, t_seq)
    return ms + lp.pp * act


def feasible(perf_e: Optional[ModulePerf], perf_l: ModulePerf,
             ep: Optional[ModuleParallelism], lp: ModuleParallelism,
             t_bsz: float, t_seq: float, mem_cap: float) -> bool:
    if perf_e is not None and ep is not None:
        if encoder_mem(perf_e, ep, lp.pp, t_bsz) > mem_cap:
            return False
    return llm_mem(perf_l, lp, t_seq) <= mem_cap
