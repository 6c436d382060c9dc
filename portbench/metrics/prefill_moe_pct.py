"""prefill_moe_pct: the device's time inside the program's ``moe`` spans
(each layer's expert layer, shared MLP included) over its time inside its
``prefill`` spans, in the traced window, on the device's own clock (each
span's CUDA events, ``repro_torch.obs.device_seconds``).  A program
without those spans gives nothing.  Moves ``replay_events_per_s``, the
Granite prefill cell's rate of prefill calls."""


def read(run):
    if run.trace is None or run.trace.window is None \
            or run.stamps.get("kind") != "moe_prefill":
        return None
    try:
        from repro_torch import obs
        seconds = obs.device_seconds
    except (ImportError, AttributeError):
        return None
    total = {"repro_torch.prefill": 0.0, "repro_torch.moe": 0.0}
    for rec in obs.records():
        if rec["name"] in total:
            s = seconds(rec)
            if s is not None:
                total[rec["name"]] += s
    if total["repro_torch.prefill"] == 0.0 or total["repro_torch.moe"] == 0.0:
        return None
    return 100.0 * total["repro_torch.moe"] / total["repro_torch.prefill"]
