"""replay_staging_s: seconds from the replay call's start to the first
``ring_apply_whatif`` kernel's start on the profiler's timeline: the
schedule pass, the problem's a/w* generation, the ring's initial copy and
the trace's transfer to the device.  Moves ``replay_events_per_s``."""


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    return run.trace.first_start(lambda n: "whatif" in n)
