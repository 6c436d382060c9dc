"""ring_apply_whatif_roofline: the what-if event's least time over the
``ring_apply_whatif`` kernel's mean device time in the traced window.

The least time is ``reference/cost.bound_s`` of
``reference/cost.whatif_event_cost`` at each event's shapes (D, c, the
ring's dtype, the distinct rows the event reads and pulls, from the
reference schedule), averaged over the events: each input read once, each
output written once, whatever implements the event.  Moves
``replay_events_per_s``."""

from portbench.reference import cost


def is_kernel(name):
    return "whatif" in name


def least_times(stamps):
    sh = stamps["event_shapes"]
    out = []
    for ts_rows, read_rows in zip(sh["ts_rows"], sh["read_rows"]):
        b, o = cost.whatif_event_cost(stamps["D"], sh["c"],
                                      stamps["ring_bytes"], int(read_rows),
                                      int(ts_rows), stamps["optimizer"],
                                      stamps["ring_bytes"] == 2)
        out.append(cost.bound_s(b, o)[0])
    return out


def read(run):
    if run.trace is None or run.trace.window is None \
            or "event_shapes" not in run.stamps:
        return None
    secs, count = run.trace.device_time(is_kernel)
    if count == 0:
        return None
    least = least_times(run.stamps)
    return 100.0 * (sum(least) / len(least)) / (secs / count)
