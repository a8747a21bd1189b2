"""The device's allocated-memory peak over the window
(``torch.cuda.max_memory_allocated`` after a reset as the window opens;
a resident database stays counted)."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**20
