"""Helpers of the model tests (``test_torch_moe.py``, ``_mamba2``,
``_xlstm``, ``_encdec``, ``_lm_families``): relative errors, bit views,
seeded parameters of the JAX package's init functions carried into the
port's modules.

Tolerances: float32 is held to relative 1e-4 (``test_torch_serve.py``'s
``TOL``): the two frameworks sum in other orders."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro_torch.interop import _leaves, _tensor

TOL = 1e-4


def rel(a, b) -> float:
    """max |a - b| / max |a|, both read as float32."""
    if isinstance(b, torch.Tensor):
        b = b.detach().float().numpy()
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def bits(x) -> np.ndarray:
    """A leaf's raw bits from either package (bf16 and f16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind != "i" else a


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(tree: dict, seed: int, scale: float = 0.1) -> dict:
    """A copy of a reference parameter tree whose constant float leaves
    (zero biases, unit norm scales) get seeded noise, so a test sees every
    parameter."""
    rng = np.random.default_rng(seed)

    def one(x):
        a = np.asarray(x)
        if a.dtype.kind == "f" and a.size and a.std() == 0:
            a = (a.astype(np.float32)
                 + rng.normal(0, scale, a.shape)).astype(a.dtype)
        return jax.numpy.asarray(a)
    return jax.tree_util.tree_map(one, tree)


def load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Load one reference parameter tree (a block's dict) into the port's
    module of the same names, strictly."""
    module.load_state_dict({k: _tensor(v) for k, v in
                            _leaves(np_tree(tree))}, strict=True)
    return module


def cpu_gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def tree_rel(jtree, ttree) -> float:
    """The worst relative error over two cache trees of the same
    structure (paths and shapes checked); int leaves must be equal."""
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    worst = 0.0
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
        if b.dtype == torch.int8:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            worst = max(worst, rel(a, b))
    return worst
