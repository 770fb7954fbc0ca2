"""The largest device memory allocated at once during the window, GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
