"""The model stack of the port (counterpart of ``repro/models``): the
serving path — init, prefill forward, caches and decode — of the dense
attention family, the hybrid of mamba and shared attention (zamba2) and the
attention-free rwkv6.
Parameters are the reference's nested dict of tensors (see
``models/transformer.py``)."""

from repro_torch.models.transformer import (count_params, init_caches,
                                            init_model, model_decode_step,
                                            model_forward)

__all__ = ["init_model", "model_forward", "model_decode_step",
           "init_caches", "count_params"]
