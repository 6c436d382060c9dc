"""The experiment driver of the port: ``run(spec) -> RunResult``
(counterpart of ``repro/experiments/driver.py``).

``run`` executes a declarative :class:`ExperimentSpec` end to end — resolve
problem and budget, schedule the arrival trace (host-side numpy, bitwise
the reference's), replay it on ``device`` through the CUDA ring kernels
(``engine="compiled"``) or run the legacy per-arrival loop whose host PS
fires the CUDA ``ps_apply`` kernel (``engine="legacy"``), and fold trace +
metrics into a :class:`RunResult` record.  ``execute`` is the raw-callable
entry point.  Both take ``device=`` and default to ``"cuda"``; without a
card they raise unless the caller asks for ``"cpu"``.

A problem's ``grad_fn`` takes a leading slot axis (the replay computes c
gradients at once); the legacy loop computes one gradient per arrival, so
``run`` hands it :func:`per_arrival_grad` — the same ``grad_fn`` called
on a slot axis of one.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch import obs
from repro_torch.config import RunConfig
from repro_torch.core.engine import replay, replay_batch, resolve_device
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.trace import ArrivalTrace, schedule, schedule_cached
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.sweep import Sweep
from repro_torch.optim import spec_from_run
from repro_torch.optim.flatten import tree_map


def per_arrival_grad(grad_fn: Callable) -> Callable:
    """A slot-batched ``grad_fn(params, batch)`` (every leaf with a leading
    (c,) axis) as the one-minibatch gradient the legacy loop calls: both
    get a slot axis of one, the gradients lose it."""
    def fn(params, batch):
        grads = grad_fn(tree_map(lambda t: t[None], params),
                        tree_map(lambda t: t[None], batch))
        return tree_map(lambda t: t[0], grads)
    return fn


def execute(run_cfg: RunConfig, *,
            steps: int,
            grad_fn: Optional[Callable] = None,
            init_params=None,
            batch_fn: Optional[Callable] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 0,
            duration_sampler: Optional[Callable] = None,
            engine: str = "compiled",
            serve_batches=None,
            serve_eval_fn: Optional[Callable] = None,
            device="cuda") -> SimResult:
    """Run one simulation from raw callables (no problem registry).

    ``engine``: "compiled" (schedule + replay; measure-only when
    ``grad_fn`` is None; ``grad_fn`` takes a leading slot axis), "measure"
    (schedule pass only), or "legacy" (the per-arrival oracle loop in
    ``core/simulator.py``; ``grad_fn`` takes one minibatch)."""
    dev = resolve_device(device)
    if engine == "legacy":
        return simulate(run_cfg, steps=steps, grad_fn=grad_fn,
                        init_params=init_params, batch_fn=batch_fn,
                        eval_fn=eval_fn, eval_every=eval_every,
                        duration_sampler=duration_sampler, device=dev)
    if engine not in ("compiled", "measure"):
        raise ValueError(f"unknown engine {engine!r}")
    trace = schedule(run_cfg, steps, duration_sampler=duration_sampler)
    if grad_fn is None or engine == "measure":
        return SimResult(trace.clock_log(), trace.steps,
                         trace.simulated_time, trace.minibatches)
    return replay(trace, run_cfg, grad_fn=grad_fn, init_params=init_params,
                  batch_fn=batch_fn, eval_fn=eval_fn, eval_every=eval_every,
                  serve_batches=serve_batches, serve_eval_fn=serve_eval_fn,
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
               # which path produced this record: "batched" (one (B, K, D)
               # ring over a sweep group), "sequential" (per-spec replay),
               # "legacy", or "measure"
               "replay_path": replay_path}
    if sim is not None and sim.serving is not None:
        # serving lane: headline numbers into metrics so sweep tables pick
        # them up, the full summary into runtime
        summary = sim.serving.summary()
        metrics["serving_accuracy"] = summary["accuracy"]
        metrics["serving_staleness_mean"] = summary["staleness_mean"]
        metrics["serving_latency_p99_s"] = summary["latency_p99_s"]
        runtime["serving"] = summary
    return RunResult(spec=spec.echo(), metrics=metrics, curve=curve,
                     runtime=runtime,
                     staleness=_staleness_stats(trace, spec.run),
                     params=params, trace=trace)


# staged-minibatch memo: repeated replays of the same (problem, trace, μ)
# grid point reuse the staged (steps, c, …) arrays instead of re-hashing
# the whole trace.  Keys are object ids, so entries keep strong refs and
# re-check identity (an id can be recycled after gc); the bound keeps
# params-sized arrays from accumulating in long-lived processes.
_STAGED_CACHE: Dict = {}
_STAGED_CACHE_MAX = 8


def _staged_cached(problem, trace, mu: int, build: Callable):
    key = (id(problem), id(trace), mu)
    hit = _STAGED_CACHE.get(key)
    if hit is not None and hit[0] is problem and hit[1] is trace:
        return hit[2]
    staged = build()
    if staged is not None:
        if len(_STAGED_CACHE) >= _STAGED_CACHE_MAX:
            _STAGED_CACHE.pop(next(iter(_STAGED_CACHE)))
        _STAGED_CACHE[key] = (problem, trace, staged)
    return staged


class _Job:
    """One grid point, scheduled: everything replay needs, plus its slot."""

    def __init__(self, index: int, spec: ExperimentSpec):
        self.index = index
        self.spec = spec
        self.engine = spec.resolved_engine()
        self.steps = spec.resolved_steps()
        self.problem = spec.resolve_problem()
        sampler = spec.duration_sampler()
        # built-in duration models are pure in (run, steps): share one
        # trace object across repeated replays of the same grid point
        # (and let the staged-batches cache key on its identity)
        self.trace = (schedule_cached(spec.run, self.steps)
                      if sampler is None
                      else schedule(spec.run, self.steps,
                                    duration_sampler=sampler))

    @property
    def batch_fn(self):
        return self.problem.batch_fn_for(self.spec.run.minibatch)

    def staged_batches(self):
        """The whole trace's minibatches through the problem's vectorized
        staging hook (None if it offers only a per-slot ``batch_fn``).
        With learner groups the slot counters expand to the (steps, c, gs)
        member matrices (every member of a slot shares its push
        counter)."""
        stage = getattr(self.problem, "stage_minibatches", None)
        if stage is None:
            return None

        def build():
            members = self.trace.member_learners()
            if members is None:
                return stage(self.trace.learner, self.trace.mb_index,
                             self.spec.run.minibatch)
            mb = np.broadcast_to(self.trace.mb_index[:, :, None],
                                 members.shape)
            return stage(members, mb, self.spec.run.minibatch)

        return _staged_cached(self.problem, self.trace,
                              self.spec.run.minibatch, build)

    def batch_exclusion(self) -> Optional[str]:
        """Why this compiled grid point can never join a batch group, or
        None when it is batch-eligible (measure/legacy jobs are also None:
        they have no batched path to fall off)."""
        if self.engine != "compiled" or self.problem is None:
            return None
        opt = spec_from_run(self.spec.run)
        if not opt.kernel_supported:
            return (f"optimizer {opt.optimizer!r} has no flat lane layout")
        if not self.trace.topology.is_trivial(self.spec.run.n_learners):
            # covers elastic grouped traces too: member_valid masks only
            # arise with group_size > 1, which is already non-trivial
            return (f"non-trivial topology (shards="
                    f"{self.spec.run.shards}, groups={self.spec.run.groups})")
        if self.spec.run.placement != "single":
            return (f"placement={self.spec.run.placement!r} replays on its "
                    f"own device mesh (no lane axis)")
        if self.trace.serving is not None:
            return ("serving lane (run.serving) adds a snapshot carry and "
                    "a post-scan request evaluation — no vmapped lane "
                    "layout")
        return None

    def batch_key(self):
        """Grid points with equal keys replay as one batch group: same
        problem (⇒ same grad_fn/init/batch shapes), trace shape (steps, c,
        mode), optimizer event, μ, eval schedule, elasticity and ring
        storage."""
        if (self.engine != "compiled" or self.problem is None
                or self.batch_exclusion() is not None):
            return None
        opt = spec_from_run(self.spec.run)
        return (id(self.problem), self.steps, self.trace.c, self.trace.mode,
                opt, self.spec.run.minibatch, self.spec.eval_every,
                self.trace.valid is not None,
                self.spec.run.ring_impl, self.spec.run.ring_dtype)

    def run_single(self, dev, init=None) -> RunResult:
        if self.engine == "measure":
            return _result(self.spec, self.trace, None, None,
                           replay_path="measure")
        dev = resolve_device(dev)
        if self.engine == "legacy":
            sim = simulate(self.spec.run, steps=self.steps,
                           grad_fn=per_arrival_grad(self.problem.grad_fn),
                           init_params=(self.problem.init(dev) if init is None
                                        else init),
                           batch_fn=self.batch_fn,
                           eval_fn=self.problem.eval_fn,
                           eval_every=self.spec.eval_every,
                           duration_sampler=self.spec.duration_sampler(),
                           device=dev)
            return _result(self.spec, self.trace, sim, self.problem,
                           replay_path="legacy")
        with obs.span("problem"):
            init_params = self.problem.init(dev) if init is None else init
            staged = self.staged_batches()
            flat_grad = getattr(self.problem, "flat_grad", None)
            if flat_grad is not None:
                flat_grad = flat_grad(dev)
        serve_kw = {}
        if self.trace.serving is not None:
            stage_requests = getattr(self.problem, "stage_requests", None)
            request_metric = getattr(self.problem, "request_metric", None)
            if stage_requests is None or request_metric is None:
                raise ValueError(
                    f"run.serving is set but problem {self.spec.problem!r} "
                    f"has no serving hooks — implement "
                    f"stage_requests(serving_trace, fleet, seed) and "
                    f"request_metric(params, request_batch) (see "
                    f"MLPProblem), or drop serving from the RunConfig")
            serve_kw = {
                "serve_batches": stage_requests(self.trace.serving,
                                                self.spec.run.serving,
                                                seed=self.spec.run.seed),
                "serve_eval_fn": request_metric,
            }
        sim = replay(self.trace, self.spec.run,
                     grad_fn=self.problem.grad_fn,
                     init_params=init_params,
                     batch_fn=None if staged is not None else self.batch_fn,
                     batches=staged,
                     eval_fn=self.problem.eval_fn,
                     eval_every=self.spec.eval_every,
                     flat_grad=flat_grad, device=dev, **serve_kw)
        with obs.span("result"):
            return _result(self.spec, self.trace, sim, self.problem,
                           replay_path="sequential")


def run(spec: ExperimentSpec, *, device="cuda", init=None) -> RunResult:
    """Execute one ExperimentSpec on ``device``.  THE public entry point.

    ``init`` (a parameter dict, e.g. the reference's initial weights
    carried across by ``experiments.carry.params_from_jax``) replaces the
    problem's own initial draw for this run.

    The call is the ``run`` span (``obs``), its schedule included; inside
    it lie ``schedule``, ``problem``, ``stage``, ``events`` and ``result``."""
    with obs.span("run"):
        return _Job(0, spec).run_single(device, init)


def run_sweep(sweep: Union[Sweep, Sequence[ExperimentSpec]], *,
              batch: bool = True, device="cuda") -> List[RunResult]:
    """Execute a grid of specs on ``device``; results in spec order.

    ``batch=True`` (default) replays shape-compatible compiled grid points
    as one (B, K, D) ring per group (``core.engine.replay_batch``);
    ``batch=False`` forces sequential per-spec execution (the equivalence
    oracle).  Compiled grid points that cannot batch (non-kernel
    optimizer, non-trivial topology, serving lane) raise ONE
    RuntimeWarning per sweep naming the reasons, and every RunResult
    records the path that produced it in ``runtime["replay_path"]``
    ("batched" | "sequential" | "legacy" | "measure").
    """
    specs = list(sweep)
    jobs = [_Job(i, s) for i, s in enumerate(specs)]
    results: List[Optional[RunResult]] = [None] * len(jobs)

    groups: Dict = {}
    if batch:
        reasons: Dict[str, int] = {}
        for job in jobs:
            why = job.batch_exclusion()
            if why is not None:
                reasons[why] = reasons.get(why, 0) + 1
            key = job.batch_key()
            if key is not None:
                groups.setdefault(key, []).append(job)
        if reasons:
            detail = "; ".join(f"{n} spec(s): {why}"
                               for why, n in sorted(reasons.items()))
            warnings.warn(
                f"run_sweep: {sum(reasons.values())} of {len(jobs)} "
                f"spec(s) fall back from the batched (vmapped) sweep path "
                f"to sequential per-spec replay — {detail}. Sequential "
                f"replay is ~3.6x slower per spec; see "
                f"runtime['replay_path'] on each RunResult.",
                RuntimeWarning, stacklevel=2)

    done = set()
    for key, members in groups.items():
        if len(members) < 2:
            continue
        dev = resolve_device(device)
        staged = [j.staged_batches() for j in members]
        if any(s is None for s in staged):
            staged = None
        sims = replay_batch(
            [j.trace for j in members],
            [j.spec.run for j in members],
            grad_fn=members[0].problem.grad_fn,
            init_params=members[0].problem.init(dev),
            batch_fns=(None if staged else [j.batch_fn for j in members]),
            batches=staged,
            eval_fn=members[0].problem.eval_fn,
            eval_every=members[0].spec.eval_every, device=dev)
        for job, sim in zip(members, sims):
            results[job.index] = _result(job.spec, job.trace, sim,
                                         job.problem, replay_path="batched")
            done.add(job.index)

    for job in jobs:
        if job.index not in done:
            with obs.span("run"):
                results[job.index] = job.run_single(device)
    return results
