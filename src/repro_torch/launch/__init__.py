"""Launcher of the port (counterpart of ``repro/launch``): ``mesh`` (the
SPMD replay's mesh of ``torch.distributed`` ranks and the abstract
production meshes), ``sharding`` (the partition specs), ``specs`` (meta
stand-ins of a step's arguments), ``roofline`` and ``dryrun`` (a step's
cost on a mesh of H100s, traced without a device), ``report`` and
``dryrun_campaign`` (the campaign over every arch × shape and its
tables), and the train CLI (``train``)."""
