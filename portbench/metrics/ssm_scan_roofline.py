"""ssm_scan_roofline: the SSD scan's least time over its mean device time
in the traced window.  A scan call is the four ``ssd_*`` kernels of
``csrc/ssm_scan.cu``, one call per Mamba2 layer and prefill; the least
time is ``reference/prefill_cost.ssm_scan_least_s`` at the cell's shapes
(B / C in the configuration's groups).  Moves
``replay_events_per_s``, the prefill cell's rate of prefill calls."""

from portbench.reference import prefill_cost


def is_kernel(name):
    return "ssd_" in name and "_kernel" in name


def read(run):
    if run.trace is None or run.trace.window is None \
            or run.stamps.get("kind") != "prefill":
        return None
    secs, count = run.trace.device_time(is_kernel)
    if count == 0:
        return None
    s, cfg = run.stamps, run.config
    calls = s["prefills"] * cfg["num_hidden_layers"]
    least = prefill_cost.ssm_scan_least_s(cfg, s["batch"], s["seq"])
    return 100.0 * least * calls / secs
