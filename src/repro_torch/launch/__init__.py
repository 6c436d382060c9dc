"""Launcher of the port (counterpart of ``repro/launch``).  So far only
``roofline.ring_bytes``, the replay carry's byte model that the
``sim_engine`` and ``kernels`` cells report; the mesh, sharding, dry-run
and train CLI wait for ROADMAP.md items 8–10."""
