"""DFLOP core: the paper's contribution (the port's copy of the planner).

  profiling/   — Profiling Engine (§3.2): Model Profiler + Data Profiler
  optimizer/   — Data-aware 3D Parallelism Optimizer (§3.3, Algorithm 1)
  scheduler/   — Online Microbatch Scheduler (§3.4): hybrid ILP/LPT +
                 Adaptive Correction
  pipeline/    — the pipeline-schedule simulator
  engine       — façade wiring profile -> plan -> schedule
"""
