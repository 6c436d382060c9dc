"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``).  Sources live
in ``csrc/`` and build on first use (``build.py``); importing this package
needs neither a card nor ``nvcc``."""
