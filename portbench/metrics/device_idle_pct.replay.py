"""device_idle_pct.replay: the share of the traced replay call in which no
operation ran on the device.  Moves ``replay_events_per_s``."""


def read(run):
    if run.trace is None or run.trace.window is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
