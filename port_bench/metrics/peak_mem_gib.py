"""``torch.cuda.max_memory_allocated()`` over the window, after a reset
when it opens, in GiB."""


def read(run):
    return run.window.peak_window / 2**30 if run.window.peak_window else None
