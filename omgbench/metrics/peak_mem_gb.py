"""``peak_mem_gb`` (end to end): the device's peak allocated memory over
set-up and the window (``torch.cuda.max_memory_allocated``), the pool of
right-hand sides included, in GB (1e9 bytes).  Nothing off the card."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 1e9
