"""The device memory the window allocated at its peak
(``torch.cuda.max_memory_allocated`` after a reset before the window),
GiB."""


def read(run):
    return run.window.peak_bytes / 2 ** 30 or None
