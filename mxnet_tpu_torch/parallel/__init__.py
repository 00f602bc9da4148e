"""Parallelism (counterpart of ``mxnet_tpu/parallel``), on one device.

The reference replaces MXNet's KVStore reduce/broadcast with XLA
collectives over a device mesh, and trains through one compiled step
program (``spmd.py``) that its ``DataParallelTrainer`` (``dp.py``)
drives.  The port has the one-device part: the trainer, its step
program and the multi-tensor optimizer updates (``ingraph_opt.py``).
Meshes, collectives and the tensor-, pipeline-, sequence- and
expert-parallel modules wait for the KVStore and parallelism slice
(ROADMAP.md Queue 1 item 7).
"""
from .dp import DataParallelTrainer, FusedDPTrainer
from .spmd import get_step_program, program_cache_stats, \
    reset_program_cache

__all__ = ["DataParallelTrainer", "FusedDPTrainer", "get_step_program",
           "program_cache_stats", "reset_program_cache"]
