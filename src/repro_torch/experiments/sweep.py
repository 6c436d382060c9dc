"""Sweep: the declarative grid builder over ExperimentSpecs (counterpart of
``repro/experiments/sweep.py``; pure Python, DESIGN.md §5).

The paper is a *systematic sweep* over (σ, μ, λ, protocol, LR policy); a
:class:`Sweep` expresses such a grid as a base spec plus named axes:

    sweep = Sweep.over(base,
                       protocol=["hardsync", "softsync"],
                       minibatch=[4, 128],
                       seed=range(5))
    results = run_sweep(sweep)          # on the card; device="cpu" too

Axis names resolve against ``RunConfig`` fields first (protocol, minibatch,
n_learners, seed, base_lr, …, including the elastic axes ``membership`` —
:class:`~repro_torch.membership.MembershipTimeline` values, tagged by their
compact ``str()`` form — and ``backup``), then against ``ExperimentSpec``
fields (steps, epochs, eval_every, …).  The special axis ``cases`` takes
dicts of coupled field patches — e.g. the paper's (protocol, n_softsync,
lr_policy) combinations that only make sense together:

    Sweep.over(base, cases=[
        {"protocol": "hardsync", "lr_policy": "sqrt_scale"},
        {"protocol": "softsync", "n_softsync": 1,
         "lr_policy": "staleness_inverse"},
    ], seed=range(3))

Grid points are the cartesian product in axis-declaration order; each spec
gets an auto-tag like ``"protocol=softsync/seed=2"`` (a ``tag`` key inside
a case dict overrides its fragment).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List

from repro_torch.config import RunConfig
from repro_torch.experiments.spec import ExperimentSpec

_RUN_FIELDS = {f.name for f in dataclasses.fields(RunConfig)}
_SPEC_FIELDS = {f.name for f in dataclasses.fields(ExperimentSpec)} - {"run"}


def _apply(spec: ExperimentSpec, patch: Dict) -> ExperimentSpec:
    """Patch a spec: keys split between RunConfig and ExperimentSpec."""
    run_kw = {k: v for k, v in patch.items() if k in _RUN_FIELDS}
    spec_kw = {k: v for k, v in patch.items() if k in _SPEC_FIELDS}
    unknown = set(patch) - set(run_kw) - set(spec_kw)
    if unknown:
        raise ValueError(f"unknown sweep field(s) {sorted(unknown)}; "
                         f"RunConfig fields: {sorted(_RUN_FIELDS)}; "
                         f"ExperimentSpec fields: {sorted(_SPEC_FIELDS)}")
    if run_kw:
        spec_kw["run"] = spec.run.replace(**run_kw)
    return spec.replace(**spec_kw) if spec_kw else spec


def _fragment(axis: str, value) -> str:
    if axis == "cases":
        return value.get("tag", "/".join(f"{k}={v}"
                                         for k, v in value.items()))
    return f"{axis}={value}"


class Sweep:
    """A base ExperimentSpec crossed with named axes (see module docstring).
    Iterating yields the grid's ExperimentSpecs in product order."""

    def __init__(self, base: ExperimentSpec, axes: Dict[str, Iterable]):
        self.base = base
        self.axes = {name: list(values) for name, values in axes.items()}
        for name, values in self.axes.items():
            if not values:
                raise ValueError(f"axis {name!r} is empty")
            if name != "cases" and name not in _RUN_FIELDS | _SPEC_FIELDS:
                raise ValueError(f"unknown axis {name!r}")

    @classmethod
    def over(cls, base: ExperimentSpec, **axes) -> "Sweep":
        """The grid builder: ``Sweep.over(base, protocol=[...], seed=[...])``."""
        return cls(base, axes)

    def __len__(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return n

    def specs(self) -> List[ExperimentSpec]:
        names = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            spec = self.base
            frags = []
            for name, value in zip(names, combo):
                patch = dict(value) if name == "cases" else {name: value}
                spec = _apply(spec, patch)
                frags.append(_fragment(name, value))
            tag = "/".join(f for f in frags if f)
            if self.base.tag:
                tag = f"{self.base.tag}/{tag}" if tag else self.base.tag
            out.append(spec.replace(tag=tag))
        return out

    def __iter__(self):
        return iter(self.specs())
