"""The model stack of the port (counterpart of ``repro/models``): the
serving path — init, prefill forward, caches and decode — and the training
loss (``model_loss``, through autograd) of every block family of the
reference: dense attention, MoE (``moe``, ``moe_dense``), the hybrid of
mamba and shared attention (zamba2) and the attention-free rwkv6, with
the audio and vision frontends; and, beside the reference's presets, the
published Zamba2 hybrid (``config.HybridConfig``, ``models/hybrid.py``).
Parameters are the reference's nested dict of tensors (see
``models/transformer.py``)."""

from repro_torch.models.transformer import (count_params, init_caches,
                                            init_model, model_decode_step,
                                            model_forward, model_loss)

__all__ = ["init_model", "model_forward", "model_loss", "model_decode_step",
           "init_caches", "count_params"]
