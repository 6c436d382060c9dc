"""Plain references and the yardstick's arithmetic: plain PyTorch and
NumPy, independent of the measured program."""
