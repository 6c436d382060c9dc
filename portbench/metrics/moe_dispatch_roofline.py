"""moe_dispatch_roofline: the MoE dispatch's least time over its device
time in the traced window.  A dispatch call is the three
``moe_dispatch_*`` kernels of ``csrc/moe_route.cu``, one call per layer and
prefill; the least time is ``reference/granite_cost.dispatch_least_s``
at the cell's shapes (its bytes over the HBM rate).  A program without
those kernels gives nothing.  Moves ``replay_events_per_s``, the Granite
prefill cell's rate of prefill calls."""

from portbench.reference import granite_cost


def is_kernel(name):
    return "moe_dispatch_" in name and "_kernel" in name


def read(run):
    if run.trace is None or run.trace.window is None \
            or run.stamps.get("kind") != "moe_prefill":
        return None
    secs, count = run.trace.device_time(is_kernel)
    if count == 0:
        return None
    s, cfg = run.stamps, run.config
    calls = s["prefills"] * cfg["num_hidden_layers"]
    least = granite_cost.dispatch_least_s(cfg, s["batch"], s["seq"])
    return 100.0 * least * calls / secs
