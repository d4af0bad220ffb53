"""Share of the window's row tokens that lie in segments (a count over its
batches): the part of each row's GEMM and attention work that is real."""
import numpy as np


def read(rec):
    segs = [np.asarray(s["segment_ids"]) for s in rec["window"]["steps"]]
    total = sum(s.size for s in segs)
    return 100.0 * sum(int((s > 0).sum()) for s in segs) / total if total else None
