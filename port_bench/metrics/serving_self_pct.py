"""Share of the drive thread's seconds, over the chunk steps traced with
the profiler off, spent outside the engine's generate, resume and refill
calls: harvest, admission, host copies (benchmark spans)."""


def read(run):
    q = run.window.quiet
    if q.wall_s <= 0 or not run.batched:
        return None
    return 100.0 * (q.wall_s - q.engine_s) / q.wall_s
