"""The port's host-side schedule layer against the reference, bit for bit.

``repro_torch``'s schedule pass (``core/trace.py`` and the numpy modules it
rests on: config, membership, topology, clock, lr_policies, tradeoff,
serve/publication, serve/fleet) is a copy of ``repro``'s with its imports
rewritten.  Every ``ArrivalTrace`` array must therefore be ``array_equal``
— same values, same dtype — to the reference's over a grid of protocols ×
λ × duration models × membership × PS shards, and the config dataclasses
must carry the same fields.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses

import numpy as np
import pytest

from repro import config as jconfig
from repro.core import trace as jtrace
from repro.experiments import spec as jspec
from repro.membership import MembershipTimeline as JTimeline
from repro.serve import fleet as jfleet
from repro.serve.publication import PublicationPolicy as JPolicy
from repro_torch import config as tconfig
from repro_torch.core import trace as ttrace
from repro_torch.experiments import spec as tspec
from repro_torch.membership import MembershipTimeline as TTimeline
from repro_torch.serve import fleet as tfleet
from repro_torch.serve.publication import PublicationPolicy as TPolicy

STEPS = 40


def assert_same(ref, port, where="trace"):
    """Recursive equality: dataclasses field by field, arrays by value AND
    dtype, everything else with ==."""
    if dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(port).__name__, where
        for f in dataclasses.fields(ref):
            assert_same(getattr(ref, f.name), getattr(port, f.name),
                        f"{where}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), where
        assert ref.dtype == port.dtype, f"{where}: {ref.dtype} vs {port.dtype}"
        assert np.array_equal(ref, port), where
    else:
        assert ref == port, f"{where}: {ref!r} vs {port!r}"


PROTOCOLS = [("hardsync", 1), ("softsync", 1), ("softsync", 4)]
DURATIONS = ["homogeneous", "two_speed", "calibrated:base"]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("duration", DURATIONS)
@pytest.mark.parametrize("lam", [4, 16])
@pytest.mark.parametrize("protocol,n", PROTOCOLS)
def test_schedule_bitwise(protocol, n, lam, duration, crash, shards):
    kw = dict(protocol=protocol, n_softsync=n, n_learners=lam, minibatch=8,
              base_lr=0.05, lr_policy="staleness_inverse",
              duration_model=duration, shards=shards,
              shard_pull_jitter=0.3 if shards > 1 else 0.0, seed=3)
    if crash:
        j_run = jconfig.RunConfig(
            membership=JTimeline.crash_restart([1], 2.0, 3.0), **kw)
        t_run = tconfig.RunConfig(
            membership=TTimeline.crash_restart([1], 2.0, 3.0), **kw)
    else:
        j_run, t_run = jconfig.RunConfig(**kw), tconfig.RunConfig(**kw)
    ref = jtrace.schedule(j_run, STEPS)
    port = ttrace.schedule(t_run, STEPS)
    assert_same(ref, port)
    assert ref.max_staleness == port.max_staleness
    assert np.array_equal(ref.event_coef(), port.event_coef())
    assert_same(ref.clock_log().staleness_histogram(),
                port.clock_log().staleness_histogram())


@pytest.mark.parametrize("lr_policy", ["const", "per_gradient", "sqrt_scale"])
def test_schedule_cached_and_lrs(lr_policy):
    """The LR policies (incl. the sequential-mode per_gradient LRs) and the
    memoized schedule give the reference's arrays."""
    kw = dict(protocol="softsync", n_softsync=2, n_learners=8, minibatch=4,
              base_lr=0.1, lr_policy=lr_policy, seed=1)
    ref = jtrace.schedule_cached(jconfig.RunConfig(**kw), STEPS)
    port = ttrace.schedule_cached(tconfig.RunConfig(**kw), STEPS)
    assert_same(ref, port)


def test_schedule_serving_lane_bitwise():
    """A serving fleet's publication / request schedule resolves bitwise."""
    def run(mod_cfg, fleet_mod, policy_cls):
        fleet = fleet_mod.FleetConfig(replicas=2, request_rate=2.0,
                                      request_samples=8,
                                      policy=policy_cls(max_version_lag=2))
        return mod_cfg.RunConfig(protocol="softsync", n_learners=4,
                                 n_softsync=2, minibatch=16, serving=fleet)
    ref = jtrace.schedule(run(jconfig, jfleet, JPolicy), STEPS)
    port = ttrace.schedule(run(tconfig, tfleet, TPolicy), STEPS)
    assert ref.serving is not None and ref.serving.n_requests > 0
    assert_same(ref, port)
    assert np.array_equal(ref.version_at(ref.serving.request_time),
                          port.version_at(port.serving.request_time))


@pytest.mark.parametrize("ref_cls,port_cls,n_fields", [
    (jconfig.RunConfig, tconfig.RunConfig, 36),
    (jfleet.FleetConfig, tfleet.FleetConfig, 11),
    (jspec.ExperimentSpec, tspec.ExperimentSpec, 9),
])
def test_field_audit(ref_cls, port_cls, n_fields):
    """The port's config dataclasses carry exactly the reference's fields
    (names, order, defaults), so a new reference field fails loudly here."""
    def fields(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            out.append((f.name, repr(default)))
        return out
    assert len(dataclasses.fields(ref_cls)) == n_fields
    assert fields(ref_cls) == fields(port_cls)


def test_param_count_matches():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert tget("qwen2_1_5b").param_count() == jget(
        "qwen2_1_5b").param_count() == 1_777_086_464
