"""Sharded serving over torch.distributed (port of the serving half of
``m3asr_tpu/parallel``): ``mesh`` (the rank mesh, layouts, the
forward's collectives), ``distributed`` (process-group bring-up) and
``ep`` (explicit expert-parallel dispatch). Import the submodules; this
package imports none of them, so the ops can use ``mesh`` without a
cycle through ``ep``."""
