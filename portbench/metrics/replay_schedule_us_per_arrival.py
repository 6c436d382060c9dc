"""replay_schedule_us_per_arrival: the ``repro_torch.schedule`` span's
time on the profiler's timeline, in microseconds, over the arrivals the
schedule counted at its end (its heap pops): the queue's cost an arrival.
Moves ``replay_events_per_s``."""

from portbench import spans


def read(run):
    secs = spans.seconds(run, "schedule")
    arrivals = spans.count("schedule", "arrivals")
    if secs is None or not arrivals:
        return None
    return secs * 1e6 / arrivals
