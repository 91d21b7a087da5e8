"""Batched execution backend: plan-derived batch schedules
(:mod:`.batching`), the batched-driver contract with device gather/scatter
(:mod:`.base`), the batched garbler/evaluator and plaintext oracle
(:mod:`.batched_gc`), the batched CKKS driver (:mod:`.batched_ckks`), the
batched Shamir driver (:mod:`.batched_shamir`) and the overlap schedules
that hide NET latency (:mod:`.overlap`)."""

from .base import BatchedProtocolDriver
from .batched_ckks import BatchedCkksDriver
from .batched_gc import BatchedGCDriver, BatchedPlaintextDriver
from .batched_shamir import BatchedShamirDriver
from .batching import BatchSchedule, build_batch_schedule
from .overlap import OverlapSchedule, build_overlap_schedule

__all__ = ["BatchSchedule", "BatchedCkksDriver", "BatchedGCDriver",
           "BatchedPlaintextDriver", "BatchedProtocolDriver",
           "BatchedShamirDriver", "OverlapSchedule", "build_batch_schedule",
           "build_overlap_schedule"]
