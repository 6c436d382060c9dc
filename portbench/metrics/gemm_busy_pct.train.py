"""gemm_busy_pct.train: the share of the device's busy time in the
training window spent in matrix-multiply kernels, selected by name (cuBLAS
and CUTLASS GEMMs).  Moves ``train_tokens_per_s``."""

import re

GEMM = re.compile(r"gemm|cutlass|xmma|cublas", re.IGNORECASE)


def read(run):
    if run.trace is None or run.trace.window is None or not run.trace.device:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    gemm, _ = run.trace.device_time(lambda n: bool(GEMM.search(n)))
    return 100.0 * gemm / busy
