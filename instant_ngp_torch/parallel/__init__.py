"""Data parallelism over ``torch.distributed`` (port of
``instant_ngp_tpu/parallel``): ``sharding`` and the multi-process dry run
``dryrun``."""
