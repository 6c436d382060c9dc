"""The trainer's synthetic language-model batches, worked out again for the
reference: a frozen copy of ``repro_torch.data.synthetic.lm_token_stream``
(reached through ``repro_torch.data.pipeline.make_batch_fn`` for a model
without a frontend), so that the reference trains on the rows the
program's trainer drew from the same seed.

Each row follows an affine chain x_{t+1} = (a·x_t + b) mod V with its own
(a, b, x_0), drawn from ``numpy.random.default_rng(seed·1 000 003 +
step)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int,
             step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed * 1_000_003 + step)
    a = rng.integers(1, vocab - 1, size=(batch, 1))
    b = rng.integers(0, vocab - 1, size=(batch, 1))
    x0 = rng.integers(0, vocab, size=(batch, 1))
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, :1] = x0
    for t in range(seq):
        toks[:, t + 1] = (a[:, 0] * toks[:, t] + b[:, 0]) % vocab
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((batch, seq), np.float32)}
