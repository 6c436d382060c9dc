"""Carry the reference's parameters into the port.

``repro``'s problems draw their initial weights with ``jax.random``, which
the port cannot reproduce.  To replay the *same* run in both packages, take
the reference's parameters as numpy arrays (``np.asarray`` of each leaf —
the only form in which they cross the package boundary) and turn them into
the port's parameter dict; ``driver.run(spec, init=...)`` then starts from
them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """``{name: array}`` (the reference's parameter dict, as numpy) → the
    port's ``{name: tensor}`` on ``device``, bit for bit (dtype kept)."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in np_params.items()}
