"""The serving loop (the port's copy of the reference's ``serve``): admission,
the execution backends (emulated and real) and the model's serving steps."""
from repro_torch.serve.admission import FIFOAdmission, PrefillPricer, SLOAdmission
from repro_torch.serve.backend import (DecodeOutcome, EmulatedBackend,
                                       ExecutionBackend, PrefillOutcome)
from repro_torch.serve.engine import ServeConfig, ServeEngine, ServeReport
from repro_torch.serve.real import RealBackend
from repro_torch.serve.request import Request, RequestQueue
from repro_torch.serve.steps import (clear_cache_row, extract_cache_row,
                                     greedy_generate, make_decode_step,
                                     make_prefill_step, merge_cache_row,
                                     pow2_chunks, prefill_into_cache,
                                     prefill_into_cache_chunked)

__all__ = [
    "FIFOAdmission", "PrefillPricer", "SLOAdmission",
    "DecodeOutcome", "EmulatedBackend", "ExecutionBackend", "PrefillOutcome",
    "RealBackend",
    "ServeConfig", "ServeEngine", "ServeReport",
    "Request", "RequestQueue",
    "clear_cache_row", "extract_cache_row", "greedy_generate",
    "make_decode_step", "make_prefill_step", "merge_cache_row",
    "pow2_chunks", "prefill_into_cache", "prefill_into_cache_chunked",
]
