"""Launcher of the port (counterpart of ``repro/launch``).  So far
``roofline.ring_bytes`` (the replay carry's byte model that the
``sim_engine``, ``kernels`` and ``ring`` cells report), ``mesh`` (the SPMD
replay's mesh of ``torch.distributed`` ranks) and the SPMD specs of
``sharding``; the dry-run, the parameter shardings and the train CLI wait
for ROADMAP.md items 9–10."""
