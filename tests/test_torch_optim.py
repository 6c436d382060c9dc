"""The port's update events against the reference's jnp twins.

Inputs are numpy draws from a seed, handed to both packages.  Tolerances
are in "ulps at scale": max |ref − port| ≤ N · spacing(max |ref|) in fp32.

* ``update_event`` and the flat events called eagerly agree within 1 ulp
  at scale (XLA's CPU adagrad division rounds differently from an IEEE
  division in the last bit).
* The ring events are compared with the twins **jitted**, as the
  reference engine runs them.  XLA then fuses the event and contracts
  multiply-adds into FMAs and phrases the combine as ``einsum``, where
  the port rounds every product and sum separately in slot order
  0…c−1 (the order the CUDA kernels use).  Measured ≤ 1 ulp at scale;
  the bound is 2.  Rows the event does not write, and the optimizer
  state's layout, are bitwise.
* With a bf16 ring the master weights (row + fp32 residue) obey the same
  bound and the quantized row may differ by at most one bf16 rounding.
"""

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import replay_ring
from repro_torch.optim import UpdateSpec as TSpec, update_event as t_update
from repro_torch.optim import flatten as tflatten
from repro_torch.optim.backends import (apply_event_flat as t_flat,
                                        apply_event_ring as t_ring,
                                        apply_event_ring_whatif as t_whatif,
                                        resolve_ring_impl)

D, C, K = 2816, 4, 3
OPTS = ["sgd", "momentum", "adagrad"]
ULPS = 2


@pytest.fixture(scope="module")
def J():
    """The reference package, imported here and not at module level so the
    card-only tests below collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    from repro.optim import UpdateSpec, flatten, update_event
    from repro.optim import backends
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, Spec=UpdateSpec, update=update_event,
        flatten=flatten, flat=backends.apply_event_flat,
        ring=backends.apply_event_ring,
        whatif=backends.apply_event_ring_whatif)


def close(ref, port, ulps=ULPS, dtype=np.float32):
    ref = np.asarray(ref, np.float32)
    port = np.asarray(port, np.float32)
    scale = np.spacing(dtype(np.max(np.abs(ref)))).astype(np.float32)
    err = np.max(np.abs(ref - port))
    assert err <= ulps * scale, f"max |diff| {err} > {ulps} x {scale}"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "w": rng.normal(size=D).astype(f32),
        "s": np.abs(rng.normal(size=D)).astype(f32),
        "g": rng.normal(size=(C, D)).astype(f32),
        "coef": np.full(C, 1.0 / C, f32),
        "lrs": rng.uniform(0.01, 0.1, C).astype(f32),
        "ring": rng.normal(size=(K, D)).astype(f32),
        "res": (rng.normal(size=D) * 1e-3).astype(f32),
        "a": rng.uniform(0.5, 1.5, D).astype(f32),
        "wstar": rng.normal(size=D).astype(f32),
        "ts": np.array([0, 2, 2, 1], np.int32),
    }


def _state(opt, data):
    return None if opt == "sgd" else data["s"]


def _j(x):
    """A jax array on a private copy: jax on the CPU may alias a numpy
    buffer without copying, and the port writes its operands in place."""
    import jax.numpy as jnp
    return None if x is None else jnp.asarray(np.array(x, copy=True))


def _t(x):
    return None if x is None else torch.tensor(x)


def _rings(data, dtype, J=None):
    """The same ring in both packages; a bf16 ring is rounded once by torch
    and handed to jax exactly (bf16 values are exact in fp32)."""
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    t = torch.tensor(data["ring"]).to(tdt)
    j = None
    if J is not None:
        j = _j(t.float().numpy()).astype(
            J.jnp.bfloat16 if dtype == "bf16" else J.jnp.float32)
    res = data["res"] if dtype == "bf16" else None
    return j, t, res


def _np_update(opt, w, s, g, lr):
    """``update_event`` op for op in numpy fp32, a third opinion beside the
    jnp twin.  Every numpy operation here is correctly rounded; torch's
    CPU ``sqrt`` is not on every build (≤ 1 ulp off in ~0.7 % of elements
    on torch 2.13's AVX-512 kernels), so adagrad agrees within 1 ulp and
    sgd / momentum bitwise."""
    f32 = np.float32
    if opt == "sgd":
        return w - lr * g, s
    if opt == "momentum":
        v = f32(0.9) * s + g
        return w - lr * v, v
    a = s + g * g
    return w - lr * g / (np.sqrt(a) + f32(1e-8)), a


@pytest.mark.parametrize("opt", OPTS)
def test_update_event(opt, data, J):
    """Against numpy, then against the jnp twin, each within 1 ulp: a
    failure of the second alone is then the reference's, of the first the
    port's."""
    sv = _state(opt, data)
    jw, js = J.update(J.Spec(opt), _j(data["w"]), _j(sv), _j(data["g"][0]),
                      J.jnp.float32(data["lrs"][0]))
    tw, ts = t_update(TSpec(opt), _t(data["w"]), _t(sv), _t(data["g"][0]),
                      torch.tensor(data["lrs"][0]))
    nw, ns = _np_update(opt, data["w"], sv, data["g"][0], data["lrs"][0])
    if opt == "adagrad":
        close(nw, tw.numpy(), ulps=1)
    else:
        assert np.array_equal(tw.numpy(), nw)
    assert sv is None or np.array_equal(ts.numpy(), ns)
    close(jw, tw.numpy(), ulps=1)
    if sv is not None:
        close(js, ts.numpy(), ulps=1)


@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_apply_event_flat(opt, mode, data, J):
    sv = _state(opt, data)
    args = [data[k] for k in ("g", "coef", "lrs")]
    jw, js = J.flat(J.Spec(opt), _j(data["w"]), _j(sv), *map(_j, args),
                    mode)
    tw, ts = t_flat(TSpec(opt), _t(data["w"]), _t(sv), *map(_t, args), mode)
    close(jw, tw.numpy(), ulps=1)
    if sv is not None:
        close(js, ts.numpy(), ulps=1)


def _check_ring(jout, tout, dtype, prev_rows=(0, 1), slot=2):
    import jax.numpy as jnp
    jring = np.asarray(jout[0].astype(jnp.float32))
    tring = tout[0].float().numpy()
    assert np.array_equal(jring[list(prev_rows)], tring[list(prev_rows)])
    if dtype == "bf16":
        close(jring[slot] + np.asarray(jout[2]),
              tring[slot] + tout[2].numpy())
        close(jring[slot], tring[slot], ulps=1, dtype=jnp.bfloat16)
    else:
        close(jring[slot], tring[slot])
    if jout[1] is not None:
        close(jout[1], tout[1].numpy())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_apply_event_ring(opt, mode, dtype, data, J):
    sv = _state(opt, data)
    jr, tr, res = _rings(data, dtype, J)
    twin = J.jax.jit(functools.partial(J.ring, J.Spec(opt), mode=mode))
    jout = twin(jr, _j(sv), _j(res), *(_j(data[k]) for k in
                                      ("g", "coef", "lrs")),
                J.jnp.int32(1), J.jnp.int32(2))
    J.jax.block_until_ready(jout)
    tout = t_ring(TSpec(opt), tr, _t(sv), _t(res),
                  *(_t(data[k]) for k in ("g", "coef", "lrs")),
                  torch.tensor(1), torch.tensor(2), mode)
    _check_ring(jout, tout, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt", OPTS)
def test_apply_event_ring_whatif(opt, dtype, data, J):
    sv = _state(opt, data)
    jr, tr, res = _rings(data, dtype, J)
    keys = ("a", "wstar", "ts", "coef", "lrs")
    twin = J.jax.jit(functools.partial(J.whatif, J.Spec(opt)))
    jout = twin(jr, _j(sv), _j(res), *(_j(data[k]) for k in keys),
                J.jnp.int32(1), J.jnp.int32(2))
    J.jax.block_until_ready(jout)
    tout = t_whatif(TSpec(opt), tr, _t(sv), _t(res),
                    *(_t(data[k]) for k in keys),
                    torch.tensor(1), torch.tensor(2))
    _check_ring(jout, tout, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt", OPTS)
def test_whatif_k1_through_wrapper(opt, dtype, data, J):
    """K = 1 (hardsync): prev = slot = every tsⱼ = row 0.  The wrapper
    takes it (as the kernel does on the card) and matches the jnp twin."""
    sv = _state(opt, data)
    jr, tr, res = _rings(data, dtype, J)
    jr, tr = jr[:1], tr[:1].contiguous()
    ts = np.zeros(C, np.int32)
    keys = ("a", "wstar", "coef", "lrs")
    a, wstar, coef, lrs = (data[k] for k in keys)
    twin = J.jax.jit(functools.partial(J.whatif, J.Spec(opt)))
    jout = twin(jr, _j(sv), _j(res), _j(a), _j(wstar), _j(ts), _j(coef),
                _j(lrs), J.jnp.int32(0), J.jnp.int32(0))
    J.jax.block_until_ready(jout)
    replay_ring.reset_launches()
    tout = replay_ring.ring_apply_whatif(
        tr, _t(sv), _t(res), _t(a), _t(wstar), _t(coef), _t(lrs),
        torch.zeros(2 + C, dtype=torch.int32), spec=TSpec(opt))
    assert replay_ring.launches["ring_apply_whatif"] == 0
    _check_ring(jout, tout, dtype, prev_rows=(), slot=0)


def test_whatif_streaming_is_exact(data, monkeypatch):
    """Streaming D in chunks changes no value (columns are independent)."""
    from repro_torch.optim import backends
    spec = TSpec("adagrad")
    keys = ("a", "wstar", "ts", "coef", "lrs")
    outs = []
    for chunk in (D, 1000):
        monkeypatch.setattr(backends, "WHATIF_CHUNK", chunk)
        _, tr, res = _rings(data, "bf16")
        outs.append(t_whatif(spec, tr, _t(data["s"]), _t(res),
                             *(_t(data[k]) for k in keys),
                             torch.tensor(1), torch.tensor(2)))
    for x, y in zip(outs[0], outs[1]):
        assert torch.equal(x, y)


def test_flatten_sorts_keys_like_jax(J):
    """jax.tree_util orders dict leaves by sorted key; the port must too,
    or the ring would be silently permuted against the reference."""
    rng = np.random.default_rng(1)
    shapes = {"w1": (3, 5), "b1": (5,), "w2": (5, 2), "b2": (2,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    layout = tflatten.layout_of(tparams)
    assert layout.keys == ("b1", "b2", "w1", "w2")
    ref = np.asarray(J.flatten.tree_to_flat({k: J.jnp.asarray(v)
                                             for k, v in params.items()}))
    flat = tflatten.tree_to_flat(tparams)
    assert np.array_equal(ref, flat.numpy())
    back = tflatten.flat_to_tree(flat, layout)
    assert all(torch.equal(back[k], tparams[k]) for k in shapes)
    batched = {k: torch.stack([v, 2 * v]) for k, v in tparams.items()}
    bflat = tflatten.batched_tree_to_flat(batched)
    assert torch.equal(bflat[1], 2 * flat)
    bback = tflatten.batched_flat_to_tree(bflat, layout)
    assert all(torch.equal(bback[k], batched[k]) for k in shapes)


@pytest.mark.parametrize("mode", ["combine", "sequential"])
def test_ring_apply_on_cpu_takes_plain_version(mode, data):
    """On CPU tensors the wrapper runs the plain version — bitwise — and
    counts no kernel launch."""
    spec = TSpec("momentum")
    _, tr, res = _rings(data, "bf16")
    _, tr2, _ = _rings(data, "bf16")
    args = [_t(data[k]) for k in ("g", "coef", "lrs")]
    replay_ring.reset_launches()
    out = replay_ring.ring_apply(tr, _t(data["s"]), _t(res), *args,
                                 torch.tensor([1, 2], dtype=torch.int32),
                                 spec=spec, mode=mode)
    ref = t_ring(spec, tr2, _t(data["s"]), _t(res), *args,
                 torch.tensor(1), torch.tensor(2), mode)
    assert replay_ring.launches == {"ring_apply": 0, "ring_apply_whatif": 0}
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_ring_apply_whatif_on_cpu_takes_plain_version(data):
    spec = TSpec("sgd")
    keys = ("a", "wstar")
    _, tr, _ = _rings(data, "fp32")
    _, tr2, _ = _rings(data, "fp32")
    idx = torch.tensor([1, 2, *data["ts"]], dtype=torch.int32)
    replay_ring.reset_launches()
    out = replay_ring.ring_apply_whatif(
        tr, None, None, *(_t(data[k]) for k in keys), _t(data["coef"]),
        _t(data["lrs"]), idx, spec=spec)
    ref = t_whatif(spec, tr2, None, None, *(_t(data[k]) for k in keys),
                   idx[2:], _t(data["coef"]), _t(data["lrs"]), idx[0], idx[1])
    assert replay_ring.launches["ring_apply_whatif"] == 0
    assert torch.equal(out[0], ref[0])


def test_wrapper_validates_inputs(data):
    spec = TSpec("momentum")
    _, tr, _ = _rings(data, "fp32")
    idx = torch.tensor([1, 2], dtype=torch.int32)
    args = [_t(data[k]) for k in ("g", "coef", "lrs")]
    with pytest.raises(ValueError, match="state vector"):
        replay_ring.ring_apply(tr, None, None, *args, idx, spec=spec)
    with pytest.raises(ValueError, match="idx has dtype"):
        replay_ring.ring_apply(tr, _t(data["s"]), None, *args, idx.long(),
                               spec=spec)
    with pytest.raises(ValueError, match="idx must hold"):
        replay_ring.ring_apply_whatif(
            tr, _t(data["s"]), None, _t(data["a"]), _t(data["wstar"]),
            args[1], args[2], idx, spec=spec)
    with pytest.raises(ValueError, match="no kernel path"):
        replay_ring.ring_apply(tr, _t(data["s"]), None, *args, idx,
                               spec=TSpec("adamw"))


def test_resolve_ring_impl():
    assert resolve_ring_impl("auto", TSpec("sgd")) == "kernel"
    assert resolve_ring_impl("pallas", TSpec("momentum")) == "kernel"
    assert resolve_ring_impl("fused", TSpec("adagrad")) == "fused"
    assert resolve_ring_impl("auto", TSpec("adamw")) == "stock"
    with pytest.raises(ValueError):
        resolve_ring_impl("nope", TSpec("sgd"))


# ---------------------------------------------------------------------------
# on the card: kernel ≡ plain version, bitwise (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [K, 1])
@pytest.mark.parametrize("width", [D, D + 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["combine", "sequential"])
@pytest.mark.parametrize("opt", OPTS)
def test_ring_apply_kernel_bitwise_on_card(opt, mode, dtype, width, rows,
                                           cuda):
    """rows = 1 is hardsync's ring: prev = slot = row 0, read and written
    by the same launch."""
    rng = np.random.default_rng(2)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ring = torch.tensor(rng.normal(size=(rows, width)).astype(np.float32),
                        device=cuda).to(tdt)
    s = (None if opt == "sgd" else
         torch.tensor(np.abs(rng.normal(size=width)).astype(np.float32),
                      device=cuda))
    res = (torch.tensor((rng.normal(size=width) * 1e-3).astype(np.float32),
                        device=cuda) if dtype == "bf16" else None)
    g = torch.tensor(rng.normal(size=(C, width)).astype(np.float32),
                     device=cuda)
    coef = torch.full((C,), 1.0 / C, device=cuda)
    lrs = torch.tensor(rng.uniform(0.01, 0.1, C).astype(np.float32),
                       device=cuda)
    idx = torch.tensor([1, 2] if rows > 1 else [0, 0], dtype=torch.int32,
                       device=cuda)
    spec = TSpec(opt)
    clone = (lambda x: None if x is None else x.clone())
    plain = t_ring(spec, ring.clone(), clone(s), clone(res), g, coef, lrs,
                   idx[0], idx[1], mode)
    replay_ring.reset_launches()
    kern = replay_ring.ring_apply(ring, s, res, g, coef, lrs, idx,
                                  spec=spec, mode=mode)
    torch.cuda.synchronize()
    assert replay_ring.launches["ring_apply"] == 1
    for x, y in zip(kern, plain):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [K, 1])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt", OPTS)
def test_ring_apply_whatif_kernel_bitwise_on_card(opt, dtype, rows, cuda):
    """rows = 1 is hardsync's ring: prev = slot = every tsⱼ = row 0."""
    rng = np.random.default_rng(3)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def dev(x):
        return torch.tensor(x.astype(np.float32), device=cuda)
    ring = dev(rng.normal(size=(rows, D))).to(tdt)
    s = None if opt == "sgd" else dev(np.abs(rng.normal(size=D)))
    res = dev(rng.normal(size=D) * 1e-3) if dtype == "bf16" else None
    a, wstar = dev(rng.uniform(0.5, 1.5, D)), dev(rng.normal(size=D))
    coef = torch.full((C,), 1.0 / C, device=cuda)
    lrs = dev(rng.uniform(0.01, 0.1, C))
    idx = torch.tensor([1, 2, 0, 2, 2, 1] if rows > 1 else [0] * (2 + C),
                       dtype=torch.int32, device=cuda)
    spec = TSpec(opt)
    clone = (lambda x: None if x is None else x.clone())
    plain = t_whatif(spec, ring.clone(), clone(s), clone(res), a, wstar,
                     idx[2:], coef, lrs, idx[0], idx[1])
    replay_ring.reset_launches()
    kern = replay_ring.ring_apply_whatif(ring, s, res, a, wstar, coef, lrs,
                                         idx, spec=spec)
    torch.cuda.synchronize()
    assert replay_ring.launches["ring_apply_whatif"] == 1
    for x, y in zip(kern, plain):
        assert (x is None and y is None) or torch.equal(x, y)
