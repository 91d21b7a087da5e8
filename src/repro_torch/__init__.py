"""The PyTorch/CUDA port of the MAGE reproduction, beside the JAX package
``repro`` (which stays the reference).

Same layout and names as the JAX package, so each module's counterpart is
easy to find; the port imports neither JAX nor anything of ``repro``.
This slice runs a planned two-party garbled-circuit job end to end on one
card: trace → plan (MIN replacement + scheduled prefetching swaps) →
execute, with the engine's frames in device memory, swap storage in
pinned host memory, and every AND gate through the hand-written half-gates
kernels (``kernels/garble``).

    from repro_torch import JobSpec, Session
    spec = JobSpec("merge", n=16384, memory_budget=0.4, prefetch_pages=64)
    Session(spec).execute(real=True, check=True)   # device="cpu" for tests
"""

from .api import JobSpec, Session

__all__ = ["JobSpec", "Session"]
