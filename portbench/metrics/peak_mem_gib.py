"""The window's peak of allocated device memory (``max_memory_allocated``
after a reset at the window's start), GiB."""


def read(rec):
    peak = rec["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak is not None else None
