#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14 alone, on one NVIDIA card: the training
engines at qwen2_1_5b's full width and depth, their fidelity, checkpoints,
the train CLI and the ``cnn`` cell.

    python3 tools/train_probe.py

Sets phase 1's matmul precision (TF32 off, bf16 products reduced in fp32),
builds the kernels (``ps_apply`` and ``ring_apply`` run on this path),
then runs phase 14 with the card's name and power limit printed first.
Exits nonzero without a card.
"""

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_probe.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(torch.cuda.get_device_name(0), cs.smi_line(), torch.__version__,
          torch.version.cuda, flush=True)
    t = time.time()
    build.build_all()
    print("build", round(time.time() - t, 1), flush=True)
    launches = {"ring_apply": 0, "ps_apply": 0}
    t = time.time()
    with tempfile.TemporaryDirectory(prefix="results_torch_") as keep:
        cs.phase_training(torch.device("cuda"), launches, Path(keep))
    print("phase 14", round(time.time() - t, 1), launches, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
