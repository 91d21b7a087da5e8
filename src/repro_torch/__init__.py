"""The PyTorch/CUDA port of the MAGE reproduction, beside the JAX package
``repro`` (which stays the reference).

Same layout and names as the JAX package, so each module's counterpart is
easy to find; the port imports neither JAX nor anything of ``repro``.
It runs planned secure-computation jobs end to end on one card: trace →
plan (replacement under MIN, MinClean, LRU or FIFO + scheduled
prefetching swaps) → execute, with the engine's frames in device memory,
swap storage in pinned host memory or a swap file, and every AND gate
(garbled circuits) or NTT and modular product (CKKS) through hand-written
kernels (``kernels/garble``, ``kernels/ntt``); the paper's unbounded
baseline (``plan_mode="unbounded"``) and scalar engine loop; and
multi-worker jobs (``num_workers`` engines a party, NET_* directives
between them) on the overlap backend (``exec_backend="overlap"``).

    from repro_torch import JobSpec, Session
    spec = JobSpec("merge", n=16384, memory_budget=0.4, prefetch_pages=64)
    Session(spec).execute(real=True, check=True)   # device="cpu" for tests

It also serves dense language models (``models``, ``serve``,
``launch.serve``): prefill and greedy decode, with ``--paged`` decode
attention through the paged-attention kernel (``kernels/paged_attn``)
over a paged KV cache.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --paged
"""

from .api import JobSpec, Session

__all__ = ["JobSpec", "Session"]
