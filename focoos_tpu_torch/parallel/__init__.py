"""Processes, devices and the data mesh (port of focoos_tpu/parallel/):
``mesh`` (ranks, collectives, the global-batch reductions of the losses and
norms), ``launch`` (one process per device) and ``sharding`` (``dp`` as
DistributedDataParallel, ``fsdp`` as FSDP2 ``fully_shard``)."""
