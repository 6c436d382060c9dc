"""replay_stage_s: seconds of the ``repro_torch.stage`` span in the traced
replay call, on the profiler's timeline: the ring and its residue built
from the initial weights, and the trace's inputs moved to the device.
Moves ``replay_events_per_s``."""

from portbench import spans


def read(run):
    return spans.seconds(run, "stage")
