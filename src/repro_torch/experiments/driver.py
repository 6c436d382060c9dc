"""The experiment driver of the port: ``run(spec) -> RunResult``
(counterpart of ``repro/experiments/driver.py``).

``run`` executes a declarative :class:`ExperimentSpec` end to end — resolve
problem and budget, schedule the arrival trace (host-side numpy, bitwise
the reference's), replay it on ``device`` through the CUDA ring kernels,
and fold trace + metrics into a :class:`RunResult` record.  ``execute`` is
the raw-callable entry point.  Both take ``device=`` and default to
``"cuda"``; without a card they raise unless the caller asks for
``"cpu"``.

Not ported yet: ``run_sweep`` and its batched replay (ROADMAP.md queue 1
items 4.6 and 5) and the legacy per-arrival oracle (item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.config import RunConfig
from repro_torch.core.engine import replay, resolve_device
from repro_torch.core.simulator import SimResult
from repro_torch.core.trace import ArrivalTrace, schedule, schedule_cached
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ExperimentSpec


def _legacy_not_ported():
    return NotImplementedError(
        "engine='legacy' (the per-arrival host-PS oracle) is not ported to "
        "repro_torch yet (ROADMAP.md queue 1 item 7); run it on repro")


def execute(run_cfg: RunConfig, *,
            steps: int,
            grad_fn: Optional[Callable] = None,
            init_params=None,
            batch_fn: Optional[Callable] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 0,
            duration_sampler: Optional[Callable] = None,
            engine: str = "compiled",
            device="cuda") -> SimResult:
    """Run one simulation from raw callables (no problem registry).

    ``engine``: "compiled" (schedule + replay; measure-only when
    ``grad_fn`` is None) or "measure" (schedule pass only)."""
    dev = resolve_device(device)
    if engine == "legacy":
        raise _legacy_not_ported()
    if engine not in ("compiled", "measure"):
        raise ValueError(f"unknown engine {engine!r}")
    trace = schedule(run_cfg, steps, duration_sampler=duration_sampler)
    if grad_fn is None or engine == "measure":
        return SimResult(trace.clock_log(), trace.steps,
                         trace.simulated_time, trace.minibatches)
    return replay(trace, run_cfg, grad_fn=grad_fn, init_params=init_params,
                  batch_fn=batch_fn, eval_fn=eval_fn, eval_every=eval_every,
                  device=dev)


# ---------------------------------------------------------------------------
# spec → RunResult
# ---------------------------------------------------------------------------
_SERIES_HEAD = 50


def _staleness_stats(trace: ArrivalTrace, run_cfg: RunConfig) -> Dict:
    """The Fig.-4 statistics block of every record, off the trace."""
    log = trace.clock_log()
    vals = log.all_staleness_values()
    expected = run_cfg.expected_staleness
    return {
        "mean": log.mean_staleness(),
        "min": float(vals.min()) if len(vals) else 0.0,
        "max": float(vals.max()) if len(vals) else 0.0,
        "expected": expected,
        "frac_exceeding_2n": log.fraction_exceeding(2 * max(1.0, expected)),
        "ring_buffer_K": trace.max_staleness + 1,
        "histogram": log.staleness_histogram().tolist(),
        "series_head": log.average_staleness_series()[:_SERIES_HEAD].tolist(),
    }


def _result(spec: ExperimentSpec, trace: ArrivalTrace,
            sim: Optional[SimResult], problem,
            replay_path: str = "sequential") -> RunResult:
    metrics: Dict = {}
    curve: List[Dict] = []
    params = None
    if sim is not None and sim.params is not None:
        params = sim.params
        metrics = dict(problem.eval_fn(params))
        curve = list(sim.history or [])
    runtime = {"simulated_time": trace.simulated_time,
               "updates": trace.steps,
               "minibatches": trace.minibatches,
               "replay_path": replay_path}
    return RunResult(spec=spec.echo(), metrics=metrics, curve=curve,
                     runtime=runtime,
                     staleness=_staleness_stats(trace, spec.run),
                     params=params, trace=trace)


def _staged_batches(problem, trace: ArrivalTrace, mu: int):
    """The whole trace's minibatches through the problem's vectorized
    staging hook (None when it offers only a per-slot ``batch_fn``)."""
    stage = getattr(problem, "stage_minibatches", None)
    if stage is None:
        return None
    return stage(trace.learner, trace.mb_index, mu)


def run(spec: ExperimentSpec, *, device="cuda", init=None) -> RunResult:
    """Execute one ExperimentSpec on ``device``.  THE public entry point.

    ``init`` (a parameter dict, e.g. the reference's initial weights
    carried across by ``experiments.carry.params_from_jax``) replaces the
    problem's own initial draw for this run."""
    dev = resolve_device(device)
    engine = spec.resolved_engine()
    steps = spec.resolved_steps()
    problem = spec.resolve_problem()
    sampler = spec.duration_sampler()
    trace = (schedule_cached(spec.run, steps) if sampler is None
             else schedule(spec.run, steps, duration_sampler=sampler))
    if engine == "measure":
        return _result(spec, trace, None, None, replay_path="measure")
    if engine == "legacy":
        raise _legacy_not_ported()
    staged = _staged_batches(problem, trace, spec.run.minibatch)
    flat_grad = getattr(problem, "flat_grad", None)
    sim = replay(trace, spec.run,
                 grad_fn=problem.grad_fn,
                 init_params=problem.init(dev) if init is None else init,
                 batch_fn=(None if staged is not None
                           else problem.batch_fn_for(spec.run.minibatch)),
                 batches=staged,
                 eval_fn=problem.eval_fn,
                 eval_every=spec.eval_every,
                 flat_grad=None if flat_grad is None else flat_grad(dev),
                 device=dev)
    return _result(spec, trace, sim, problem, replay_path="sequential")

