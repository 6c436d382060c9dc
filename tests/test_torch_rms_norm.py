"""The RMSNorm kernel's wrapper (``kernels/rms_norm.py``, ``ops.rms_norm``)
and the hybrid forward that launches it.

On the CPU: the wrapper runs the plain version, ``layers.rms_norm`` bit for
bit, in bf16 and fp32, and over two column pieces ``rms_norm`` of their
concatenation bit for bit; the hybrid ``SMOKE`` forward with
``use_pallas`` on CPU tensors is the plain path's bit for bit; the norms
the forward takes with ``use_pallas`` are the plain lines over the
concatenated shared-block input.  The wrapper's refusal of autograd is
``test_torch_zamba2_instruct.py::test_glue_wrappers_refuse_autograd``.

On the card (``-m cuda``): the kernel against its plain version at the
``zamba2_7b.prefill`` cell's widths (3 584, and 2 × 3 584 as two pieces)
and at row counts and widths that fill no whole block, within one ulp in
bf16 and 8 in fp32; the operands it does not take are refused.
One prefill's launches are ``test_torch_zamba2_instruct.py::
test_smoke_prefill_launches_the_glue_on_card``'s.
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses

import pytest
import torch

from repro_torch.config import RunConfig
from repro_torch.configs import zamba2_7b_instruct as zi
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import hybrid, init_model, layers
from repro_torch.serve import engine

KERNELS = RunConfig(attn_impl="pallas", use_pallas=True)
PLAIN = RunConfig(attn_impl="pallas", use_pallas=False)


def _operands(shape, widths, dtype, seed, device="cpu"):
    """Rows of random activations in ``widths`` pieces, a scale near 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pieces = [(3 * torch.randn(*shape, w, generator=gen, device=device))
              .to(dtype) for w in widths]
    scale = (1 + 0.1 * torch.randn(sum(widths), generator=gen,
                                   device=device)).to(dtype)
    return pieces, scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("widths", [(48,), (48, 40)], ids=["one", "two"])
def test_wrapper_is_the_plain_lines_on_cpu(widths, dtype):
    pieces, scale = _operands((3, 5), widths, dtype, 1)
    got = kops.rms_norm(pieces[0], scale, 1e-5,
                        tail=pieces[1] if len(pieces) > 1 else None)
    want = layers.rms_norm(torch.cat(pieces, dim=-1), scale, 1e-5)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert rn.launches["rms_norm"] == 0


def test_wrapper_checks_shapes_on_cpu():
    (x, e), scale = _operands((2, 3), (16, 8), torch.bfloat16, 2)
    with pytest.raises(ValueError, match="scale"):
        kops.rms_norm(x, scale, tail=None)
    with pytest.raises(ValueError, match="tail"):
        kops.rms_norm(x, scale, tail=e[:1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_forward_on_cpu_is_the_plain_path(dtype, monkeypatch):
    """``SMOKE`` (two hybrid layers, both shared blocks) through the
    forward with the kernels' switch on and off, bit for bit; and the
    shared block's input norm under the switch is the plain lines over
    concat(x, e)."""
    cfg = dataclasses.replace(zi.SMOKE, dtype=dtype)
    params = init_model(cfg, 3, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = engine.prefill_step(cfg, KERNELS, params, {"tokens": tok})
        want = engine.prefill_step(cfg, PLAIN, params, {"tokens": tok})
    assert got.dtype == want.dtype and torch.equal(got, want)
    w = params["shared"]["0"]
    pieces, _ = _operands((2, 24), (cfg.d_model,) * 2,
                          w["input_norm"].dtype, 4)
    seen = []

    def spy(x, scale, eps=1e-5, *, tail=None):
        seen.append(rn.rms_norm(x, scale, eps, tail=tail))
        return seen[-1]
    monkeypatch.setattr(kops, "rms_norm", spy)
    with torch.no_grad():
        hybrid._qkv(cfg, w, *pieces, torch.arange(24), use_pallas=True)
    assert len(seen) == 1 and torch.equal(seen[0], layers.rms_norm(
        torch.cat(pieces, dim=-1), w["input_norm"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the rms_norm kernel)")
    return torch.device("cuda")


def _within_ulps(got, want, n):
    """No element of ``got`` more than ``n`` ulps of its dtype (of the
    larger of the two) from ``want``; returns the share of elements that
    differ at all."""
    eps = torch.finfo(got.dtype).eps
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.full_like(big, eps), torch.frexp(big)[1] - 1)
    diff = (g - w).abs()
    assert int((diff > n * ulp).sum()) == 0, float((diff / ulp).max())
    return float((diff > 0).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,widths,dtype", [
    ((8, 4096), (3584,), torch.bfloat16),
    ((8, 4096), (3584, 3584), torch.bfloat16),
    ((8, 4096), (3584,), torch.float32),
    ((8, 4096), (3584, 3584), torch.float32),
    ((3, 45), (3584, 3584), torch.bfloat16),
    ((5, 7), (520,), torch.bfloat16),
    ((37,), (12288, 4096), torch.float32)],
    ids=["cell_bf16", "cell_cat_bf16", "cell_fp32", "cell_cat_fp32",
         "ragged_cat", "narrow", "widest_fp32"])
def test_kernel_matches_plain_on_card(cuda, shape, widths, dtype):
    """The cell's widths (each layer's norm; the shared block's input norm
    as two pieces) at its 32 768 rows, 135 rows, a width of 65 vectors (one
    warp and a lane) and the widest row the kernel takes: one launch each.
    bf16 (the model's dtype): within one ulp of the plain version, on at
    most 1e-3 of the elements.  fp32: within 8 ulps.  The kernel and the
    plain version sum a row's W squares in another order, which moves 1/rms
    and so a whole row by a few fp32 ulps (up to 4 at the cell's widths on
    one H100, 11-14 % of the elements); in bf16 that shows only where an
    output lies next to a rounding boundary."""
    pieces, scale = _operands(shape, widths, dtype, 5, cuda)
    tail = pieces[1] if len(pieces) > 1 else None
    rn.reset_launches()
    got = rn.rms_norm(pieces[0], scale, 1e-5, tail=tail)
    assert rn.launches["rms_norm"] == 1
    want = rn.rms_norm_plain(pieces[0], scale, 1e-5, tail=tail)
    assert got.shape == want.shape == shape + (sum(widths),)
    share = _within_ulps(got, want, 1 if dtype == torch.bfloat16 else 8)
    if dtype == torch.bfloat16:
        assert share <= 1e-3


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    (x, e), scale = _operands((4, 3), (64, 64), torch.bfloat16, 6, cuda)
    cases = {
        "mixed dtypes": lambda: rn.rms_norm(x, scale.float(), tail=e),
        "fp16": lambda: rn.rms_norm(x.half(), scale[:64].half()),
        "not contiguous": lambda: rn.rms_norm(
            x.transpose(0, 1), scale[:64]),
        "width not a multiple of 8": lambda: rn.rms_norm(
            x[..., :60].contiguous(), scale[:60]),
        "too wide": lambda: rn.rms_norm(
            torch.zeros(2, 16392, dtype=x.dtype, device=cuda),
            torch.ones(16392, dtype=x.dtype, device=cuda)),
        "scale of another width": lambda: rn.rms_norm(x, scale, tail=None),
        "two devices": lambda: rn.rms_norm(x, scale.cpu(), tail=e),
    }
    rn.reset_launches()
    for name, call in cases.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(name)
    assert rn.launches["rms_norm"] == 0
