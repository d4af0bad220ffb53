"""Low-overhead span recorder with Chrome-trace (Perfetto) JSON export: the
controller's `TraceRecorder` and the process's recorder of program spans.

Both live in ``repro_torch.common.trace``, a leaf module that the loader,
the scheduler and the train step import without the runtime package (which
imports the scheduler); this module re-exports them for the runtime's
side.
"""
from repro_torch.common.trace import (  # noqa: F401
    DEVICE_TID,
    THREAD_TID0,
    TraceRecorder,
    recorder,
    recording,
    set_batch,
    span,
)
