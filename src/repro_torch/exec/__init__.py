"""Batched execution backend: plan-derived batch schedules
(:mod:`.batching`), the batched-driver contract with device gather/scatter
(:mod:`.base`) and the batched garbler/evaluator (:mod:`.batched_gc`)."""

from .base import BatchedProtocolDriver
from .batched_gc import BatchedGCDriver
from .batching import BatchSchedule, build_batch_schedule

__all__ = ["BatchSchedule", "BatchedGCDriver", "BatchedProtocolDriver",
           "build_batch_schedule"]
