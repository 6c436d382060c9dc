"""replay_schedule_s: seconds of the ``repro_torch.schedule`` span in the
traced replay call, on the profiler's timeline: the arrival queue's pass
over every arrival of the call's events.  Moves ``replay_events_per_s``."""

from portbench import spans


def read(run):
    return spans.seconds(run, "schedule")
