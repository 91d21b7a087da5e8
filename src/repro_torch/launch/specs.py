"""Stand-ins for every model input, plus the matching specs: the port's
copy of ``repro.launch.specs``.  Nothing is allocated: parameters,
optimizer state and caches are built as fake tensors (``FakeTensorMode``;
the reference's ``jax.eval_shape``), batches are :class:`ShapeDtype`\\ s.

Covers: params + optimizer state (train), token/frame batches, KV caches
and recurrent states (decode).  The caches are the reference's tree
(``models.lm``), so :func:`cache_pspecs` is the reference's entry for
entry.
"""

from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ShapeCell
from ..distributed.sharding import P, AxisRules, NamedSharding, distribute
from ..models import ModelConfig, grouped_layout, init_caches, init_lm
from ..models.config import BlockKind
from ..models.encdec import init_encdec
from ..train.optimizer import init_opt_state


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """The reference's ``jax.ShapeDtypeStruct``."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn, tree):
    """``fn`` over every leaf of nested lists, tuples and dicts (a spec,
    :class:`P`, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_struct(cfg: ModelConfig, mode: FakeTensorMode | None = None,
                  seed: int = 0):
    """The model with fake parameters (no storage), built under ``mode``
    (a new ``FakeTensorMode`` if None)."""
    init = init_encdec if cfg.is_encdec else init_lm
    with mode or FakeTensorMode():
        return init(cfg, seed, "cpu")


def opt_struct(params_shape, mode: FakeTensorMode | None = None) -> dict:
    """``init_opt_state`` of a model's fake parameters."""
    with mode or FakeTensorMode():
        return init_opt_state(params_shape)


def batch_specs(cfg: ModelConfig, cell: ShapeCell, rules: AxisRules,
                n_batch_shards: int):
    """Token (and frame) batch ShapeDtypes + specs."""
    b, s = cell.global_batch, cell.seq_len
    shardable = b % max(n_batch_shards, 1) == 0 and b >= n_batch_shards
    bspec = rules.axis("batch") if shardable else None
    out_shapes = {"tokens": ShapeDtype((b, s), torch.int32)}
    out_specs = {"tokens": P(bspec, None)}
    if cfg.is_encdec:
        out_shapes["frames"] = ShapeDtype((b, s, cfg.d_model),
                                          getattr(torch, cfg.dtype))
        out_specs["frames"] = P(bspec, None, None)
    return out_shapes, out_specs, shardable


def _block_cache_spec(cfg: ModelConfig, kind: BlockKind, rules: AxisRules,
                      bspec):
    kv = rules.axis("kv_heads")
    kv_seq = rules.axis("kv_seq")
    if kv_seq is None and bspec is None:
        # batch unshardable (e.g. long_500k batch=1): the data axes are idle
        # -- shard the cache's sequence dim over them instead
        kv_seq = rules.axis("batch")
    ff = rules.axis("ff")
    if kind in (BlockKind.ATTN, BlockKind.SHARED_ATTN):
        if cfg.kv_cache_dtype == "int8":
            return (P(bspec, kv_seq, kv, None), P(bspec, kv_seq, kv, None),
                    P(bspec, kv_seq, kv), P(bspec, kv_seq, kv))
        return (P(bspec, kv_seq, kv, None), P(bspec, kv_seq, kv, None))
    if kind == BlockKind.MAMBA2:
        return {"h": P(bspec, ff, None, None), "conv": P(bspec, None, None)}
    if kind == BlockKind.MLSTM:
        h = rules.axis("heads")
        return {"C": P(bspec, h, None, None), "n": P(bspec, h, None),
                "m": P(bspec, h)}
    if kind == BlockKind.SLSTM:
        return {"c": P(bspec), "n": P(bspec), "h": P(bspec), "m": P(bspec)}
    raise ValueError(kind)


def _prepend(spec_tree, n_extra: int):
    return tree_map(lambda p: P(*([None] * n_extra + list(p))), spec_tree)


def cache_pspecs(cfg: ModelConfig, rules: AxisRules, batch_shardable: bool):
    """Spec tree matching ``models.init_caches``' structure."""
    bspec = rules.axis("batch") if batch_shardable else None
    out = []
    for g in grouped_layout(cfg):
        if g[0] == "scan":
            _, kind, count = g
            out.append(_prepend(_block_cache_spec(cfg, kind, rules, bspec),
                                1))
        else:
            _, inner, n_rep = g
            out.append({f"seg{j}": _prepend(
                _block_cache_spec(cfg, kind, rules, bspec), 2)
                for j, (kind, count) in enumerate(inner)})
    return out


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int,
                 mode: FakeTensorMode | None = None):
    """``init_caches`` as fake tensors."""
    with mode or FakeTensorMode():
        return init_caches(cfg, batch, max_seq, "cpu")


def named(tree_specs, mesh):
    return tree_map(lambda p: NamedSharding(mesh, p), tree_specs)


def distribute_tree(tree, tree_specs, mesh):
    """Every tensor of ``tree`` (nested lists, tuples, dicts) as a DTensor
    on its spec in ``tree_specs`` (the same structure): caches by
    :func:`cache_pspecs`."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, tree_specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, tree_specs))
    return distribute(tree, NamedSharding(mesh, tree_specs))


def mamba_nh_shardable(cfg: ModelConfig, rules: AxisRules) -> bool:
    return rules.axis("ff") is not None
