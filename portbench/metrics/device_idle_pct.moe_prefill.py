"""device_idle_pct.moe_prefill: the share of the traced Granite prefill
window in which no operation ran on the device.  Moves
``replay_events_per_s``, the cell's rate of prefill calls."""


def read(run):
    if run.trace is None or run.trace.window is None or not run.trace.device \
            or run.stamps.get("kind") != "moe_prefill":
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
