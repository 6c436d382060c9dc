"""moe_expert_mfu: the routed experts' FLOPs over the device's time inside
the program's ``moe_experts`` spans (the expert products alone), as a
share of the card's bf16 peak (989 TFLOP/s), in the traced window.  FLOPs
are ``reference/granite_cost.expert_flops`` of every prefill in the
window; the time is each span's CUDA events
(``repro_torch.obs.device_seconds``).  A program without those spans
gives nothing.  Moves ``replay_events_per_s``, the Granite prefill cell's
rate of prefill calls."""

from portbench.reference import cost, granite_cost


def read(run):
    if run.trace is None or run.trace.window is None \
            or run.stamps.get("kind") != "moe_prefill":
        return None
    try:
        from repro_torch import obs
        seconds = obs.device_seconds
    except (ImportError, AttributeError):
        return None
    busy = 0.0
    for rec in obs.records():
        if rec["name"] == "repro_torch.moe_experts":
            s = seconds(rec)
            if s is not None:
                busy += s
    if busy == 0.0:
        return None
    s = run.stamps
    flops = granite_cost.expert_flops(run.config, s["batch"], s["seq"]) \
        * s["prefills"]
    return 100.0 * flops / (busy * cost.PEAK_BF16_FLOPS)
