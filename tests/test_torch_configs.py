"""The port's architecture registry against the reference's.

All ten ``ARCH_IDS`` in the reference's order (``ring``'s
``configs_unlocked`` joins names in that order), and for each, both the
full-scale ``CONFIG`` and the reduced ``SMOKE``: every ``ModelConfig``
field and ``param_count()`` equal, exactly (host-side data, no rounding).
"""

import torch_cpu  # noqa: F401 (this worker's share of the CPU)

import dataclasses

import pytest

from repro_torch import configs

REFERENCE_ORDER = ["internvl2_2b", "hubert_xlarge", "rwkv6_7b", "qwen3_14b",
                   "starcoder2_7b", "zamba2_7b", "llama4_maverick_400b_a17b",
                   "qwen2_1_5b", "llama3_405b", "arctic_480b"]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from repro import configs as r_configs
    return r_configs


def test_arch_ids_in_the_references_order(R):
    assert configs.ARCH_IDS == R.ARCH_IDS == REFERENCE_ORDER
    assert configs.ALIASES == R.ALIASES


@pytest.mark.parametrize("arch", REFERENCE_ORDER)
@pytest.mark.parametrize("getter", ["get_config", "get_smoke"])
def test_config_equals_reference(arch, getter, R):
    port = getattr(configs, getter)(arch)
    ref = getattr(R, getter)(arch)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.param_count() == ref.param_count()


def test_aliases_resolve():
    assert configs.get_config("llama4-maverick-400b-a17b") is \
        configs.get_config("llama4_maverick_400b_a17b")
    assert configs.get_config("qwen2-1.5b").name == "qwen2-1.5b"
    with pytest.raises(KeyError):
        configs.get_config("gpt2")
