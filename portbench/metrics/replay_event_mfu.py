"""replay_event_mfu: the replay's least time, summed over every event of
the traced call, as a share of the call's whole time: the events' share
of the card's peak rates (``reference/cost.bound_s``, the larger of the
HBM and fp32 issue bounds), whatever the events run on.  Moves
``replay_events_per_s``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_roofline_helpers",
    Path(__file__).with_name("ring_apply_whatif_roofline.py"))
_roof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roof)


def read(run):
    if run.trace is None or run.trace.window is None \
            or "event_shapes" not in run.stamps or not run.trace.device:
        return None
    return 100.0 * sum(_roof.least_times(run.stamps)) / run.trace.window_s()
