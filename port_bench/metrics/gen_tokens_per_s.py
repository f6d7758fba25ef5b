"""Generated tokens committed in the window by every slot that holds a
request, over the window's seconds (host clock), read from the per-slot
lengths at the chunk boundaries the window opens and closes on."""


def read(run):
    w = run.window
    return w.work.tokens / w.seconds if w.seconds > 0 and w.work.tokens else None
