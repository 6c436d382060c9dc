"""The declarative experiment description (DESIGN.md §5).

An :class:`ExperimentSpec` is a frozen value object holding everything one
run of the paper's study needs: the :class:`~repro_torch.config.RunConfig` (the
(σ, μ, λ) knobs), the problem (a registry name, see ``problems.py``), the
budget (``steps`` or ``epochs``), the duration model feeding the runtime
axis, the metric schedule, and an engine choice.  ``run(spec)`` executes it;
``Sweep`` builds grids of them; the spec echoes itself into every
:class:`~repro_torch.experiments.result.RunResult` so a results file is
self-describing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The calibrated-duration grammar ("calibrated:<arch>[:<int>mb]") and its
# parser live in repro_torch.config — ONE parser and error message shared with
# RunConfig.duration_model, which accepts the same strings (the two layers
# used to disagree: the spec allowed "calibrated:base:300mb" while the
# RunConfig one level down rejected it with a misleading message).
from repro_torch.config import (CALIBRATED_ARCHS, CALIBRATED_PREFIX,  # noqa: F401
                          RunConfig, parse_calibrated)
from repro_torch.experiments.problems import get_problem, updates_for_epochs

ENGINES = ("auto", "compiled", "legacy", "measure")


def _as_arg_tuple(args) -> Tuple[Tuple[str, object], ...]:
    if isinstance(args, dict):
        return tuple(sorted(args.items()))
    return tuple((str(k), v) for k, v in args)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment = one (RunConfig, problem, budget, metrics) point.

    ``problem=None`` is **measure mode**: no gradients, the schedule pass
    alone (staleness/runtime statistics — the paper's Fig. 4).  Exactly one
    of ``steps`` / ``epochs`` must be set; ``epochs`` is resolved against
    the problem's dataset size (measure mode requires explicit ``steps``).
    """

    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    problem: Optional[str] = None
    problem_args: Tuple[Tuple[str, object], ...] = ()
    steps: Optional[int] = None
    epochs: Optional[float] = None
    duration: str = "config"
    eval_every: int = 0
    engine: str = "auto"
    tag: str = ""

    def __post_init__(self):
        object.__setattr__(self, "problem_args",
                           _as_arg_tuple(self.problem_args))
        if (self.steps is None) == (self.epochs is None):
            raise ValueError("set exactly one of steps / epochs")
        if self.steps is not None and self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.duration != "config":
            try:
                parse_calibrated(self.duration)
            except ValueError as e:
                raise ValueError(
                    f"duration must be 'config' or match the calibrated "
                    f"grammar — {e}") from None
        if self.problem is None:
            if self.engine not in ("auto", "measure"):
                raise ValueError("problem=None (measure mode) only runs on "
                                 "engine 'auto'/'measure'")
            if self.epochs is not None:
                raise ValueError("measure mode needs explicit steps "
                                 "(no dataset to derive epochs from)")
        elif self.engine == "measure":
            raise ValueError("engine='measure' takes problem=None")
        if self.engine == "legacy" and (self.run.shards > 1
                                        or self.run.group_size > 1
                                        or self.run.elastic
                                        or self.run.backup
                                        or self.run.serving is not None):
            raise ValueError(
                "engine='legacy' (the per-arrival host PS) models the flat "
                "static Rudra-base server only; sharded/grouped topologies, "
                "elastic membership/backup, and serving fleets (shards/"
                "groups/membership/backup/serving on RunConfig) replay on "
                "the compiled engine")

    def replace(self, **kw) -> "ExperimentSpec":
        """Copy with fields changed; validation re-runs (frozen contract)."""
        return dataclasses.replace(self, **kw)

    # -- resolution ----------------------------------------------------------
    @property
    def measure_only(self) -> bool:
        return self.problem is None

    def resolve_problem(self):
        return (None if self.problem is None
                else get_problem(self.problem, self.problem_args))

    def resolved_steps(self) -> int:
        """The update budget: ``steps`` verbatim, or epochs·dataset samples
        converted at c·μ·group_size samples per update."""
        if self.steps is not None:
            return int(self.steps)
        prob = self.resolve_problem()
        return updates_for_epochs(self.epochs, self.run.minibatch,
                                  self.run.gradients_per_update,
                                  prob.dataset_size,
                                  group_size=self.run.group_size)

    def resolved_engine(self) -> str:
        if self.engine != "auto":
            return self.engine
        return "measure" if self.measure_only else "compiled"

    def duration_sampler(self):
        """The ``(rng, mu, learner) -> seconds`` sampler this spec implies,
        or None to defer to ``RunConfig.duration_model`` inside schedule()."""
        if self.duration == "config":
            return None
        from repro_torch.core import tradeoff as to
        arch, model_bytes = parse_calibrated(self.duration)
        wl = to.WorkloadModel()
        if model_bytes is not None:
            wl = dataclasses.replace(wl, model_bytes=model_bytes)
        if self.problem is not None:
            prob = self.resolve_problem()
            wl = dataclasses.replace(
                wl, dataset_size=prob.dataset_size,
                epochs=self.epochs if self.epochs is not None else wl.epochs)
        # calibration pins the paper's CIFAR baseline wall-clock (§5.4); the
        # workload model then rescales it to this problem's dataset/epochs
        return to.minibatch_duration_sampler(
            arch, self.run.n_learners, to.calibrate_to_baseline(), wl)

    def echo(self) -> dict:
        """The JSON config echo embedded in every RunResult record."""
        d = dataclasses.asdict(self)
        d["problem_args"] = dict(self.problem_args)
        d["run"] = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in dataclasses.asdict(self.run).items()}
        return d
