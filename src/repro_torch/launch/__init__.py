"""Launcher of the port (counterpart of ``repro/launch``).  So far
``roofline.ring_bytes`` (the replay carry's byte model that the
``sim_engine``, ``kernels`` and ``ring`` cells report), ``mesh`` (the SPMD
replay's mesh of ``torch.distributed`` ranks), the SPMD specs of
``sharding`` and the train CLI (``train``); the dry-run and the parameter
shardings wait for ROADMAP.md item 10.5."""
