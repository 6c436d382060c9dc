"""moe_prefill_mfu: the traced window's prefill FLOPs per second as a share
of the card's bf16 peak (989 TFLOP/s), in the Granite prefill cell.  FLOPs
are ``reference/granite_cost.prefill_flops`` of every prefill in the
window: 2 per applied matmul parameter and token (the chosen experts
only) plus causal attention's two products.  Moves
``replay_events_per_s``, the cell's rate of prefill calls."""

from portbench.reference import cost, granite_cost


def read(run):
    if run.trace is None or run.trace.window is None \
            or not run.trace.device or run.stamps.get("kind") != "moe_prefill":
        return None
    s = run.stamps
    flops = granite_cost.prefill_flops(run.config, s["batch"], s["seq"]) \
        * s["prefills"]
    return 100.0 * flops / (run.trace.window_s() * cost.PEAK_BF16_FLOPS)
