"""The port's tests take their share of the CPU.

pytest-xdist runs the suite in several worker processes on one host and
tells each how many there are (``PYTEST_XDIST_WORKER_COUNT``).  Torch's
intra-op pool otherwise takes every core in every worker, and the workers
then fight over the cores.  Importing this module caps torch's threads at
``launch.mesh.threads_per_process(workers)``, the rule each rank of an
SPMD world follows, and never raises them.  Every ``test_torch_*.py``
imports it first, so a file run alone or with any other files gets the
same budget.  Without xdist the cap is the whole machine and nothing
changes.
"""

import os

import torch

from repro_torch.launch import mesh

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(min(torch.get_num_threads(),
                          mesh.threads_per_process(_workers)))
