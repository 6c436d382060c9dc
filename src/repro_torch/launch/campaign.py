"""DEPRECATED alias (counterpart of ``repro/launch/campaign.py``) —
renamed to ``repro_torch.launch.dryrun_campaign`` to free the ``campaign``
name for the experiments campaign layer (DESIGN.md §15):

    PYTHONPATH=src python -m repro_torch.launch.dryrun_campaign

Importing from here keeps working; ``python -m
repro_torch.launch.campaign`` too.
"""

from __future__ import annotations

import sys

from repro_torch.launch.dryrun_campaign import (ARCHS, OUT_DIR,  # noqa: F401
                                                ROOT, SHAPES, job_hash,
                                                job_id, job_spec, main,
                                                run_job)

if __name__ == "__main__":
    print("[launch.campaign] deprecated: use `python -m "
          "repro_torch.launch.dryrun_campaign`", file=sys.stderr)
    main()
