"""Sharded serving and training over torch.distributed (port of
``m3asr_tpu/parallel``): ``mesh`` (the rank mesh, layouts, the forward's
collectives), ``distributed`` (process-group bring-up), ``ep`` (explicit
expert-parallel dispatch), ``collectives`` (the collectives autograd
sees), ``sp`` (the main blocks split over time), ``pp`` (GPipe),
``fsdp`` (parameter gathers) and ``dryrun`` (``dryrun_multichip``).
Import the submodules; this package imports none of them, so the ops can
use ``mesh`` without a cycle through ``ep``."""
