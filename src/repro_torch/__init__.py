"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module tree file for file.  The host-side
schedule layer is a numpy copy of the reference's (bitwise equal); the
replay engine runs each update event through the hand-written CUDA kernels
in ``kernels/`` on a card, or through their plain PyTorch versions on the
CPU when the caller asks for ``device="cpu"``.  It never imports JAX or
``repro``.
"""
