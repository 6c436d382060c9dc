"""flash_attention_roofline: the bf16 flash-attention kernel's least time
over its mean device time in the traced window, one launch per hybrid
layer and prefill; the least time is
``reference/prefill_cost.flash_least_s`` at the cell's shapes (causal, the
configuration's head dim).  Moves ``replay_events_per_s``, the prefill
cell's rate of prefill calls."""

from portbench.reference import prefill_cost


def is_kernel(name):
    return "flash_sm90" in name


def read(run):
    if run.trace is None or run.trace.window is None \
            or run.stamps.get("kind") != "prefill":
        return None
    secs, count = run.trace.device_time(is_kernel)
    if count == 0:
        return None
    s, cfg = run.stamps, run.config
    calls = s["prefills"] * len(cfg["hybrid_layer_ids"])
    least = prefill_cost.flash_least_s(cfg, s["batch"], s["seq"])
    return 100.0 * least * calls / secs
