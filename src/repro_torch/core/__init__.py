"""Bytecode, DSL, planner stages, engine, storage and transport of the
port (its copies of ``repro.core``, on PyTorch where data lives), and the
§8.2 timing simulator, whose names this package exports as the JAX
package's does."""

from .simulator import (DeviceModel, SimResult, simulate_memory_program,
                        simulate_os_paging, simulate_unbounded)

__all__ = ["DeviceModel", "SimResult", "simulate_memory_program",
           "simulate_os_paging", "simulate_unbounded"]
