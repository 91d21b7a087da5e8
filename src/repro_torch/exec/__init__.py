"""Batched execution backend: plan-derived batch schedules
(:mod:`.batching`), the batched-driver contract with device gather/scatter
(:mod:`.base`), the batched garbler/evaluator and plaintext oracle
(:mod:`.batched_gc`) and the batched CKKS driver (:mod:`.batched_ckks`)."""

from .base import BatchedProtocolDriver
from .batched_ckks import BatchedCkksDriver
from .batched_gc import BatchedGCDriver, BatchedPlaintextDriver
from .batching import BatchSchedule, build_batch_schedule

__all__ = ["BatchSchedule", "BatchedCkksDriver", "BatchedGCDriver",
           "BatchedPlaintextDriver", "BatchedProtocolDriver",
           "build_batch_schedule"]
