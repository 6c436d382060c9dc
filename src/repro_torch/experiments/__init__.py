"""The experiment surface of the port: declarative ``ExperimentSpec`` →
``run(spec, device=...)`` → ``RunResult`` (DESIGN.md §5).

    from repro_torch.config import RunConfig
    from repro_torch.experiments import ExperimentSpec, run

    spec = ExperimentSpec(
        run=RunConfig(protocol="softsync", n_softsync=1, n_learners=30,
                      minibatch=4, base_lr=0.1, optimizer="momentum"),
        problem="mlp_teacher", steps=300, eval_every=100)
    res = run(spec)                 # on the card; device="cpu" for the CPU
    res.metrics["test_error"], res.runtime["simulated_time"]
"""

from repro_torch.experiments.carry import params_from_jax
from repro_torch.experiments.driver import execute, run
from repro_torch.experiments.problems import (MLPProblem, QuadraticProblem,
                                              get_problem, problem_names,
                                              register_problem,
                                              updates_for_epochs)
from repro_torch.experiments.result import RunResult, SCHEMA_VERSION
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.spec_hash import spec_hash

__all__ = [
    "params_from_jax", "execute", "run", "MLPProblem", "QuadraticProblem",
    "get_problem", "problem_names", "register_problem",
    "updates_for_epochs", "RunResult", "SCHEMA_VERSION", "ExperimentSpec",
    "spec_hash",
]
