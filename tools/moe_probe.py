#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 15 alone, on one NVIDIA card: MoE and the
modality frontends at full width (llama4_maverick cut to one unit, arctic
to two layers, qwen3_14b, starcoder2_7b, hubert_xlarge, internvl2_2b),
the MoE configs at a reduced width on the card against the CPU, and the
dry-run.  Runs phase 3's flash-attention checks first (they include the
groupings phase 15 launches: G 5, 7, 9 causal and G 1 non-causal).

    python3 tools/moe_probe.py

Sets phase 1's matmul precision (TF32 off, bf16 products reduced in fp32),
builds the kernels, then prints the card's name and power limit, phase 3's
flash checks and phase 15 with the flash launches it counted.  Exits
nonzero without a card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_probe.py: no CUDA card", file=sys.stderr)
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
    dev = torch.device("cuda")
    t = time.time()
    cs.phase_flash_vs_plain(dev)
    print("phase 3 flash", round(time.time() - t, 1), flush=True)
    launches = {"flash_attention": 0, "flash_sm90": 0, "flash_tf32x3": 0}
    t = time.time()
    cs.phase_moe_frontends(dev, launches)
    print("phase 15", round(time.time() - t, 1), launches, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
