"""``ring_apply``'s lane axis and the update kernels' load width and
largest c.

* The lane axis: ``replay_ring.ring_apply`` on a (B, K, D) ring — the
  counterpart of the reference's ``jax.vmap`` of its ``pallas_call`` —
  against B calls of the one-ring plain version, bitwise (the event is
  elementwise: each lane's values come from the same operations in the
  same order), for sgd / momentum / adagrad × combine / sequential × an
  fp32 ring / a bf16 ring with its residue × one coef for every lane / a
  masked (B, c) coef × K 3 / 1 (hardsync: prev = slot).
* The same against the reference's ``jax.vmap`` of
  ``repro.kernels.replay_ring.ring_apply`` in interpret mode, at the
  tolerance of ``tests/test_torch_optim.py``'s ring tests: 2 ulps at
  scale, a bf16 row within one bf16 rounding (the Pallas kernel phrases
  the combine as an ``einsum``, the port sums in slot order).
* ``replay_batch``: one launch over the lanes (``ring_impl`` "pallas")
  bitwise the per-lane bodies (``fused``), and both the sequential
  replay's within ``tests/test_torch_sweep.py``'s tolerance.
* ``build.vec4``, the choice between the kernels' 4-wide and 1-wide
  loads, at its edges (a ragged D, a misaligned view, a bf16 view on 8
  bytes, the paper's D, D 10 000 004) and the largest c the CUDA source
  states and both wrappers take.
* On the card (``cuda``-marked, skipped without one): the lane axis with
  either load width bitwise its plain version.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import RunConfig as TRun
from repro_torch.experiments import ExperimentSpec as TSpec
from repro_torch.experiments import Sweep as TSweep, run_sweep
from repro_torch.kernels import build, ps_update, replay_ring
from repro_torch.membership import MembershipTimeline as TTimeline
from repro_torch.optim import UpdateSpec
from repro_torch.optim.backends import apply_event_ring, apply_event_ring_lanes

B, C, K, D = 3, 4, 3, 1024
OPTS = ["sgd", "momentum", "adagrad"]
ULPS = 2


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.kernels import replay_ring as ref_ring
    from repro.optim import UpdateSpec as Spec
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ring=ref_ring,
                                 Spec=Spec)


def lane_inputs(opt, dtype, masked, rows, seed=0, width=D, lanes=B,
                device="cpu"):
    """numpy draws from a seed: ring (B, K, D), s / res (B, D) or None, g
    (B, c, D), coef (c,) or (B, c) with some slots cancelled, lrs (B, c),
    idx [prev, slot]."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {
        "ring": rng.normal(size=(lanes, rows, width)).astype(f32),
        "s": (None if opt == "sgd" else
              np.abs(rng.normal(size=(lanes, width))).astype(f32)),
        "res": ((rng.normal(size=(lanes, width)) * 1e-3).astype(f32)
                if dtype == "bf16" else None),
        "g": rng.normal(size=(lanes, C, width)).astype(f32),
        "coef": (np.where(rng.uniform(size=(lanes, C)) < 0.3, 0.0,
                          1.0 / C).astype(f32) if masked
                 else np.full(C, 1.0 / C, f32)),
        "lrs": rng.uniform(0.01, 0.1, (lanes, C)).astype(f32),
        "idx": np.array([1, 2] if rows > 1 else [0, 0], np.int32),
    }
    t = {k: None if v is None else torch.tensor(v, device=device)
         for k, v in out.items()}
    if dtype == "bf16":
        t["ring"] = t["ring"].to(torch.bfloat16)
    return out, t


def clone(t):
    return {k: None if v is None else v.clone() for k, v in t.items()}


def lane_call(t, spec, mode):
    return replay_ring.ring_apply(t["ring"], t["s"], t["res"], t["g"],
                                  t["coef"], t["lrs"], t["idx"], spec=spec,
                                  mode=mode)


def per_lane_calls(t, spec, mode):
    """B calls of the one-ring plain version, each on its lane's views."""
    for b in range(t["ring"].shape[0]):
        coef = t["coef"][b] if t["coef"].dim() == 2 else t["coef"]
        apply_event_ring(spec, t["ring"][b],
                         None if t["s"] is None else t["s"][b],
                         None if t["res"] is None else t["res"][b],
                         t["g"][b], coef, t["lrs"][b], t["idx"][0],
                         t["idx"][1], mode)
    return t["ring"], t["s"], t["res"]


@pytest.mark.parametrize("rows", [K, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_lane_plain_version_equals_per_lane_calls(opt, mode, dtype, masked,
                                                  rows):
    _, t = lane_inputs(opt, dtype, masked, rows)
    want = per_lane_calls(clone(t), UpdateSpec(opt), mode)
    replay_ring.reset_launches()
    got = lane_call(t, UpdateSpec(opt), mode)
    assert replay_ring.launches["ring_apply"] == 0     # the plain version
    assert replay_ring.lane_events["ring_apply"] == 0
    for x, y in zip(got, want):
        assert (x is None and y is None) or torch.equal(x, y)


def close(ref, port, ulps=ULPS, dtype=np.float32):
    ref = np.asarray(ref, np.float32)
    port = np.asarray(port, np.float32)
    scale = np.spacing(dtype(np.max(np.abs(ref)))).astype(np.float32)
    err = np.max(np.abs(ref - port))
    assert err <= ulps * scale, f"max |diff| {err} > {ulps} x {scale}"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode,masked", [("combine", False),
                                         ("sequential", False),
                                         ("combine", True)])
@pytest.mark.parametrize("opt", OPTS)
def test_lanes_match_reference_vmap(opt, mode, masked, dtype, J):
    """The reference's ``jax.vmap`` over its ``ring_apply`` (interpret
    mode), lanes on the vmapped axis, idx shared; masked coefs in combine
    mode only, as the replay uses them (elastic traces replay in combine
    mode)."""
    arrays, t = lane_inputs(opt, dtype, masked, K, seed=1)
    jnp = J.jnp
    jring = jnp.asarray(arrays["ring"])
    if dtype == "bf16":
        jring = jring.astype(jnp.bfloat16)

    def one(ring, s, res, g, coef, lrs):
        return J.ring.ring_apply(ring, s, res, g, coef, lrs,
                                 jnp.asarray(arrays["idx"]),
                                 spec=J.Spec(opt), mode=mode, interpret=True)
    opt_j = (lambda k: None if arrays[k] is None else jnp.asarray(arrays[k]))
    jout = J.jax.vmap(one, in_axes=(0, None if arrays["s"] is None else 0,
                                    None if arrays["res"] is None else 0, 0,
                                    0 if masked else None, 0))(
        jring, opt_j("s"), opt_j("res"), jnp.asarray(arrays["g"]),
        jnp.asarray(arrays["coef"]), jnp.asarray(arrays["lrs"]))
    J.jax.block_until_ready(jout)
    tout = lane_call(t, UpdateSpec(opt), mode)
    jr = np.asarray(jout[0].astype(jnp.float32))
    tr = tout[0].float().numpy()
    assert np.array_equal(jr[:, :2], tr[:, :2])   # rows the event reads
    if dtype == "bf16":
        close(jr[:, 2] + np.asarray(jout[2]), tr[:, 2] + tout[2].numpy())
        close(jr[:, 2], tr[:, 2], ulps=1, dtype=jnp.bfloat16)
    else:
        close(jr[:, 2], tr[:, 2])
    if jout[1] is not None:
        close(jout[1], tout[1].numpy())


def _sweep(**run_kw):
    run = dict(protocol="softsync", n_softsync=1, n_learners=8, minibatch=4,
               base_lr=0.05, optimizer="momentum")
    run.update(run_kw)
    base = TSpec(run=TRun(**run), problem="mlp_teacher",
                 problem_args={"hidden": 16}, steps=18, eval_every=9)
    return TSweep.over(base, seed=[0, 1], base_lr=[0.05, 0.1])


@pytest.mark.parametrize("run_kw", [
    dict(), dict(ring_dtype="bf16"), dict(optimizer="sgd"),
    dict(lr_policy="per_gradient"),
    dict(membership=TTimeline.crash_restart([1, 2], 2.0, 3.0))])
def test_replay_batch_lane_axis_unchanged(run_kw):
    """Four lanes in one group: one ``ring_apply`` over the lanes per
    event (``pallas``) ≡ the per-lane bodies (``fused``) bitwise, and both
    within the sweep tests' tolerance of the sequential replay."""
    lanes = run_sweep(_sweep(ring_impl="pallas", **run_kw), device="cpu")
    fused = run_sweep(_sweep(ring_impl="fused", **run_kw), device="cpu")
    seq = run_sweep(_sweep(ring_impl="pallas", **run_kw), batch=False,
                    device="cpu")
    assert [r.runtime["replay_path"] for r in lanes + fused] == \
        ["batched"] * 8
    for a, f, s in zip(lanes, fused, seq):
        assert a.curve == f.curve and a.staleness == s.staleness
        for k in a.params:
            assert torch.equal(a.params[k], f.params[k])
            torch.testing.assert_close(a.params[k], s.params[k], rtol=1e-5,
                                       atol=2e-6)


def _views(lanes, ring, skip, width=16):
    """A lane-axis event's operands as small CPU views (the rule reads D
    and the bases alone): ring (lanes, 2, width) of dtype ``ring``
    starting ``skip`` elements into its buffer, s and g."""
    buf = torch.zeros(lanes * 2 * width + skip, dtype=ring)
    return (buf[skip:].view(lanes, 2, width), torch.zeros(lanes, width),
            torch.zeros(lanes, 4, width))


@pytest.mark.parametrize("D,lanes,ring,skip,want", [
    (10_000_004, 1, torch.float32, 0, 1),          # the wide lane
    (10_000_008, 1, torch.float32, 0, 1),          # 5c's padded shards
    (10_000_003, 1, torch.float32, 0, 0),          # ragged
    (2_762, 30, torch.float32, 0, 0),              # the paper's
    (2_764, 4, torch.float32, 0, 1),
    (89_580, 1, torch.float32, 0, 1),
    # a view one fp32 element off 16 bytes
    (10_000_004, 1, torch.float32, 1, 0),
    # a bf16 ring view on 8 bytes, not 16: 4 bf16 elements still aligned
    (10_000_004, 1, torch.bfloat16, 4, 1),
    (10_000_004, 1, torch.bfloat16, 2, 0),
    # 16-byte but not 128-byte aligned
    (10_000_004, 3, torch.float32, 4, 1),
    (10_000_004, 1, torch.bfloat16, 0, 1),
    (2_762, 1, torch.bfloat16, 0, 0),
    (4, 1, torch.float32, 0, 1),                   # the smallest 4-wide D
    (6, 2, torch.float32, 0, 0),
])
def test_vec4_at_its_edges(D, lanes, ring, skip, want):
    """``build.vec4``: the 4-wide loads need D % 4 == 0 and every base
    aligned to 4 of its elements (each lane's rows then are too)."""
    assert build.vec4(D, *_views(lanes, ring, skip)) == want


def test_plan_constants_match_the_cuda_source():
    """The slot check reads the largest c the kernels are built with (the
    libraries confirm it again when they load on a card): coef and lrs,
    8c bytes, within the 48 KB a launch takes without opting in."""
    src = (Path(build.CSRC) / "update_event.cuh").read_text()
    slots = int(re.search(r"constexpr int MAX_SLOTS = (\d+);", src)
                .group(1))
    assert slots == build.MAX_SLOTS == replay_ring.MAX_SLOTS \
        == ps_update.MAX_SLOTS
    assert 8 * build.MAX_SLOTS <= 48 * 1024


@pytest.mark.parametrize("c", [0, build.MAX_SLOTS + 1])
def test_largest_c_is_checked(c):
    spec = UpdateSpec("sgd")
    w = torch.zeros(8)
    g = torch.zeros(c, 8)
    coef, lrs = torch.zeros(c), torch.zeros(c)
    with pytest.raises(ValueError, match=f"c = {c} gradients; the update "
                                         f"kernels take 1 to "
                                         f"{build.MAX_SLOTS}"):
        ps_update.ps_apply(w, None, g, coef, lrs, spec=spec)
    with pytest.raises(ValueError, match=f"c = {c} gradients"):
        replay_ring.ring_apply(torch.zeros(2, 8), None, None, g, coef, lrs,
                               torch.tensor([0, 1], dtype=torch.int32),
                               spec=spec)
    with pytest.raises(ValueError, match=f"c = {c} gradients"):
        replay_ring.ring_apply(torch.zeros(2, 2, 8), None, None, g[None]
                               .expand(2, -1, -1), coef, lrs[None]
                               .expand(2, -1),
                               torch.tensor([0, 1], dtype=torch.int32),
                               spec=spec)


def test_largest_c_runs():
    spec = UpdateSpec("sgd")
    c = build.MAX_SLOTS
    g = torch.ones(c, 8)
    coef = torch.full((c,), 2.0 ** -13)       # every partial sum exact
    w2, _ = ps_update.ps_apply(torch.zeros(8), None, g, coef,
                               torch.ones(c), spec=spec)
    assert torch.equal(w2, torch.full((8,), -c * 2.0 ** -13))


def test_lane_operands_are_checked():
    _, t = lane_inputs("momentum", "fp32", False, K)
    spec = UpdateSpec("momentum")
    with pytest.raises(ValueError, match="s has shape"):
        replay_ring.ring_apply(t["ring"], t["s"][0], None, t["g"], t["coef"],
                               t["lrs"], t["idx"], spec=spec)
    with pytest.raises(ValueError, match="lrs has shape"):
        replay_ring.ring_apply(t["ring"], t["s"], None, t["g"], t["coef"],
                               t["lrs"][0], t["idx"], spec=spec)
    with pytest.raises(ValueError, match="coef has shape"):
        replay_ring.ring_apply(t["ring"], t["s"], None, t["g"],
                               t["coef"][None].expand(B + 1, -1)
                               .contiguous(), t["lrs"], t["idx"], spec=spec)
    with pytest.raises(ValueError, match="g has shape"):
        replay_ring.ring_apply(t["ring"], t["s"], None, t["g"][:2],
                               t["coef"], t["lrs"], t["idx"], spec=spec)


# ---------------------------------------------------------------------------
# on the card: the lane axis at either load width ≡ its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (width, lanes): 720 896 takes the 4-wide loads, the paper's ragged 2 762
# the 1-wide ones
CARD_SHAPES = [(720_896, 3), (2_762, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_lane_kernel_bitwise_on_card(opt, mode, dtype, masked, shape, cuda):
    width, lanes = shape
    _, t = lane_inputs(opt, dtype, masked, K, seed=5, width=width,
                       lanes=lanes, device=cuda)
    spec = UpdateSpec(opt)
    want = apply_event_ring_lanes(spec, *(clone(t)[k] for k in (
        "ring", "s", "res", "g", "coef", "lrs")), t["idx"][0], t["idx"][1],
        mode)
    assert build.vec4(width, *(t[k] for k in ("ring", "s", "res", "g"))) \
        == int(width % 4 == 0)
    replay_ring.reset_launches()
    got = lane_call(t, spec, mode)
    torch.cuda.synchronize()
    assert replay_ring.launches["ring_apply"] == 1
    assert replay_ring.lane_events["ring_apply"] == lanes
    for x, y in zip(got, want):
        assert (x is None and y is None) or torch.equal(x, y)
