"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, on the fullest card, GiB."""


def read(run):
    return run.peak_bytes / 2**30
