"""replay_tail_s: seconds from the end of the traced call's last
``ring_apply_whatif`` kernel to the end of its last ``repro_torch.result``
span, on the profiler's timeline: the part of the result (the final
weights, the loss, the staleness statistics) that the device's events do
not hide.  Moves ``replay_events_per_s``."""

from portbench import spans


def read(run):
    result = spans.intervals(run, "result")
    if not result:
        return None
    lo, hi = run.trace.window
    ends = [b for n, a, b in run.trace.device
            if "whatif" in n and lo <= a < hi]
    if not ends:
        return None
    return (max(b for _, b in result) - max(ends)) * 1e-6
