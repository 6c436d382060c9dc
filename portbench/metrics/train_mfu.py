"""train_mfu: the training window's model FLOPs per second as a share of
the card's peak for the dtype the configuration runs in (fp32 outside the
tensor cores: 67 TFLOP/s; bf16: 989).  Model FLOPs are
``reference/cost.lm_train_flops`` of every round in the traced window;
recompute is not counted.  Moves ``train_tokens_per_s``."""

from portbench.reference import cost


def read(run):
    if run.trace is None or run.trace.window is None \
            or not run.trace.device or run.stamps.get("kind") != "train":
        return None
    s = run.stamps
    flops = cost.lm_train_flops(run.config, s["batch"], s["seq"]) \
        * s["rounds"]
    peak = cost.PEAK_FLOPS_BY_DTYPE[run.config["torch_dtype"]]
    return 100.0 * flops / (run.trace.window_s() * peak)
