"""Logical-axis sharding rules (DP/TP/EP/SP) on DTensor: the port's copy of
``repro.distributed.sharding``.

Activations are constrained inside model code via ``shard(x, *logical)``;
parameters get specs from name-based rules over their names.  Changing
``AxisRules`` is the perf lever (e.g. flipping sequence sharding on for
long prefill).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.  The pod axis joins data parallelism by default (pipeline
parallelism over pods is ``distributed.pipeline``).

A spec (:class:`P`) is the reference's ``PartitionSpec`` as a tuple, one
entry a tensor dim: a mesh axis name, a tuple of names or None; so rules
and specs compare with the reference's entry by entry.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``; :class:`NamedSharding` pairs the two, as the reference's
does.

The rule functions read only a mesh's axis names and sizes, so they take a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` dict.

The port keeps one module a layer (``blocks.<i>``), where the reference
stacks a group's layers on leading axes.  A per-layer leaf has the
reference's rank less those axes, and since the rules right-align their
logical axes, its spec is the reference's with the leading ``None``\\ s
dropped.  :func:`zero_pspecs` applies the reference's rule ("the first
still-unsharded dim divisible by dp") to the per-layer leaves; where the
reference picked the stacked layer axis the two differ (ROADMAP Queue 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication


class P(tuple):
    """A partition spec: ``P("data", None)``; a tuple, so it compares with
    any tuple entry by entry, and a leaf of a spec tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"



def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mesh-like object."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass
class AxisRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""
    rules: dict[str, Any]
    grad_compression: str | None = None   # None | 'int8' (accounting flag)

    def axis(self, logical: str):
        return self.rules.get(logical)

    def spec(self, *logical: str | None) -> P:
        return P(*(self.axis(lg) if lg else None for lg in logical))


def default_rules(mesh, seq_sharding: bool = False) -> AxisRules:
    names = axis_names(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    data = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes
                                                 else None)
    model = "model" if "model" in names else None
    return AxisRules(rules={
        "batch": data,
        "seq": model if seq_sharding else None,  # SP: shard activations' seq
        "heads": model,
        "kv_heads": model,
        "ff": model,
        "vocab": model,
        "experts": model,
        "dmodel": None,
        "kv_seq": None,
        "state": None,
    })


def rules_for(cfg, mesh, seq_sharding: bool = False,
              dp_over_model: bool = False) -> AxisRules:
    """Per-config rules: a logical axis maps to the model mesh axis only if
    the corresponding dimension is divisible by the axis size (GQA models
    with few KV heads replicate KV; odd head counts fall back to ff/vocab
    tensor parallelism).

    ``dp_over_model``: fold the model axis into data parallelism (weights
    replicated, zero TP collectives) -- the right strategy for models small
    enough to replicate, where TP activation all-reduces dominate."""
    rules = default_rules(mesh, seq_sharding=seq_sharding)
    msize = axis_sizes(mesh).get("model", 1)
    if dp_over_model:
        names = axis_names(mesh)
        data = tuple(a for a in ("pod", "data", "model") if a in names)
        for k in rules.rules:
            rules.rules[k] = None
        rules.rules["batch"] = data
        rules.rules["scores_q"] = None
        rules.rules["kv_seq"] = None
        return rules

    def ok(dim: int) -> bool:
        return dim % msize == 0 and dim >= msize

    if not ok(cfg.n_heads):
        rules.rules["heads"] = None
    if not ok(cfg.n_kv_heads):
        rules.rules["kv_heads"] = None
    if not ok(cfg.d_ff if cfg.d_ff else cfg.ssm_expand * cfg.d_model):
        rules.rules["ff"] = None
    if not ok(cfg.vocab_size):
        rules.rules["vocab"] = None
    if cfg.moe and not ok(cfg.n_experts):
        rules.rules["experts"] = None
    if seq_sharding:
        # pure sequence parallelism: the model axis shards the sequence dim
        # of every activation; weight axes must then be replicated (a tensor
        # can't map one mesh axis twice)
        for k in ("heads", "kv_heads", "ff", "vocab", "experts"):
            rules.rules[k] = None
        rules.rules["seq"] = "model"
    # attention-score sharding: if KV heads cannot shard, bound the scores
    # by sharding the query-sequence dim instead
    rules.rules["scores_q"] = ("model" if rules.rules.get("kv_heads") is None
                               and msize > 1 else None)
    # KV-cache sequence sharding: with unshardable KV heads the decode cache
    # would otherwise be replicated across the model axis -- shard its seq
    # dim instead (the contraction over seq then reduces across it)
    rules.rules["kv_seq"] = ("model" if rules.rules.get("kv_heads") is None
                             and msize > 1 else None)
    return rules


_CURRENT: list[AxisRules] = []


def current_rules() -> AxisRules | None:
    return _CURRENT[-1] if _CURRENT else None


class use_rules:
    """Activate ``rules`` for ``shard``.  Inside, a plain tensor that meets
    a DTensor counts as replicated (``implicit_replication``): the model's
    constants (positions, masks, RoPE frequencies) need no conversion."""

    def __init__(self, rules: AxisRules):
        self.rules = rules
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        _CURRENT.append(self.rules)
        self._stack.enter_context(implicit_replication())
        return self.rules

    def __exit__(self, *a):
        self._stack.close()
        _CURRENT.pop()


def placements(spec: P, mesh) -> tuple:
    """A spec -> DTensor placements on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim that names its axis, else
    ``Replicate()``.  A tensor dim over a tuple of axes takes them in mesh
    order (major to minor), as the reference's PartitionSpec does."""
    names = axis_names(mesh)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} takes {axes} out of the "
                             f"mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} maps axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The local shard's shape of a tensor of ``shape`` (ceil division,
        as DTensor's first shards)."""
        sizes = axis_sizes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            axes = entry if isinstance(entry, tuple) else (entry,)
            k = math.prod(sizes[a] for a in axes if a is not None)
            out.append(-(-n // k))
        return tuple(out)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the whole tensor, on every rank) as a DTensor: each rank
    keeps its shard, with no communication."""
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def shard(x, *logical: str | None):
    """Constrain ``x`` to the active rules' spec: a DTensor is
    redistributed to its placements; a plain tensor, or anything outside
    ``use_rules``, passes as it is."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = placements(rules.spec(*logical), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# functions run on each rank's shard
# ---------------------------------------------------------------------------


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def _shard_of(x, mesh, pl: tuple, grad: tuple) -> torch.Tensor:
    """This rank's shard of ``x`` in placements ``pl`` (a plain tensor
    counts as replicated), differentiably: its gradient goes back in
    placements ``grad``, made contiguous (DTensor's view ops need
    contiguous shards)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    t = x.redistribute(mesh, pl).to_local(grad_placements=grad)
    if t.requires_grad:
        t.register_hook(_contiguous)
    return t


def local_region(fn, mesh, in_pl: tuple, out_pl: tuple, out_shape,
                 grad_pl: tuple | None = None):
    """``fn`` on each rank's shards, as torch's ``local_map`` runs it, but
    with the outputs' global shapes stated: ``local_map`` infers them from
    a shard, which is wrong where a shard is uneven (a batch that the data
    axes do not divide).  The arguments are redistributed to ``in_pl`` (a
    placements tuple an argument; ``grad_pl``: their gradients'
    placements, a ``Partial()`` where the work on the shards divides a
    mesh dim over which the argument is replicated); output i becomes a
    DTensor in ``out_pl[i]`` of global shape ``out_shape(i, shard)``.
    Returns the function of the arguments."""
    def run(*args):
        out = fn(*(_shard_of(x, mesh, p, g) for x, p, g in zip(
            args, in_pl, grad_pl or in_pl)))
        single = not isinstance(out, tuple)
        res = []
        for i, o in enumerate((out,) if single else out):
            shape = tuple(out_shape(i, o))
            res.append(DTensor.from_local(
                o.contiguous(), mesh, out_pl[i], run_check=False,
                shape=torch.Size(shape), stride=contiguous_strides(shape)))
        return res[0] if single else tuple(res)

    return run


def pad(x: torch.Tensor, pads: tuple, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, pads, value=value)``; a DTensor is padded on its shards
    (the padded dims made whole first), where DTensor's own pad strategy
    fails on some torch versions (2.11: an IndexError in its
    redistribution)."""
    if not isinstance(x, DTensor):
        return F.pad(x, pads, value=value)
    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pads) if n}
    pl = tuple(Replicate() if isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim in padded) else p
        for p in x.placements)
    shape = list(x.shape)
    for i, n in enumerate(pads):
        shape[x.ndim - 1 - i // 2] += n
    return local_region(lambda t: F.pad(t, pads, value=value),
                        x.device_mesh, (pl,), (pl,), lambda i, o: shape)(x)


def on_shards(fn, args, out_dims):
    """``fn(*shards)`` on each rank's shard of its arguments: a region that
    is parallel over some labelled dims (batch, heads, experts), as a
    shard_map is (:func:`local_region` with placements from the labels).
    ``args`` holds (tensor, dims) pairs, ``dims`` a label or None a tensor
    dim.  A mesh dim keeps the first operand's shard of a labelled dim
    that it divides evenly; every operand with that label is sharded on it
    there, the others replicated.  ``fn`` returns a tensor or a tuple,
    labelled by ``out_dims`` (a dims tuple, or a tuple of them); an output
    without a sharded label is a partial sum over that mesh dim, so ``fn``
    must be a sum over it there.  With no DTensor among the arguments,
    ``fn`` is called on them as they are."""
    dts = [x for x, _ in args if isinstance(x, DTensor)]
    if not dts:
        return fn(*(x for x, _ in args))
    mesh = dts[0].device_mesh
    labels: list = [None] * mesh.ndim
    for x, dims in args:
        if isinstance(x, DTensor):
            for i, p in enumerate(x.placements):
                if labels[i] is None and isinstance(p, Shard) \
                        and dims[p.dim] is not None \
                        and x.shape[p.dim] % mesh.size(i) == 0:
                    labels[i] = dims[p.dim]

    def pl(dims, other=Replicate()):
        return tuple(Replicate() if lb is None else
                     Shard(dims.index(lb)) if lb in dims else other
                     for lb in labels)

    size = {lb: x.shape[dims.index(lb)] for x, dims in args
            for lb in labels if lb is not None and lb in dims}
    outs = (out_dims,) if not isinstance(out_dims[0], tuple) else out_dims
    return local_region(
        fn, mesh, tuple(pl(dims) for _, dims in args),
        tuple(pl(dims, Partial()) for dims in outs),
        lambda i, o: [size.get(lb, n) for lb, n in zip(outs[i], o.shape)],
        tuple(pl(dims, Partial()) for _, dims in args))(
        *(x for x, _ in args))


# ---------------------------------------------------------------------------
# parameter shardings from parameter names
# ---------------------------------------------------------------------------

# (regex over the parameter's name, logical axes per dim -- trailing dims
# matched right-aligned)
PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed", ("vocab", None)),
    (r"lm_head", (None, "vocab")),
    (r"(wq|wkv_a|q_proj)$", (None, "heads")),
    (r"(wk|wv|k_proj|v_proj)$", (None, "kv_heads")),
    (r"(wo|o_proj)$", ("heads", None)),
    (r"(q_bias)$", ("heads",)),
    (r"(k_bias|v_bias)$", ("kv_heads",)),
    (r"(w_gate|w_up|gate_proj|up_proj)$", (None, "ff")),
    (r"(w_down|down_proj)$", ("ff", None)),
    (r"experts_.*(gate|up)$", ("experts", None, None)),
    (r"experts_.*down$", ("experts", None, None)),
    (r"router$", (None, "experts")),
    (r"(in_proj|xbc_proj)$", (None, "ff")),
    (r"(ssm_out|out_proj)$", ("ff", None)),
    (r"(mq|mk|mv)$", (None, "heads")),
    (r"m_out$", ("heads", None)),
]


def param_spec_for_path(path: str, ndim: int, rules: AxisRules) -> P:
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            axes = [rules.axis(lg) if lg else None for lg in logical]
            if len(axes) < ndim:           # left-pad
                axes = [None] * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:]
            return P(*axes)
    return P()  # replicate


def _shapes(params) -> dict[str, tuple]:
    """{name: shape} of a model's parameters (real, fake or DTensor), or of
    a {name: shape-or-tensor} dict."""
    items = params.named_parameters() if isinstance(params, nn.Module) \
        else params.items()
    return {n: tuple(getattr(p, "shape", p)) for n, p in items}


def params_pspecs(params, rules: AxisRules) -> dict[str, P]:
    """{parameter name: spec} for a model (or {name: shape})."""
    return {n: param_spec_for_path(n, len(s), rules)
            for n, s in _shapes(params).items()}


def params_shardings(params, mesh, rules: AxisRules
                     ) -> dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, s)
            for n, s in params_pspecs(params, rules).items()}


def zero_pspecs(params, rules: AxisRules, mesh) -> dict[str, P]:
    """ZeRO-style specs for optimizer state / gradient accumulators: on top
    of the parameter sharding, shard the first still-unsharded divisible dim
    over the data axes.  Weights stay DP-replicated (needed for the
    forward); the moments and float32 gradients shard dp-ways."""
    shapes = _shapes(params)
    base = params_pspecs(shapes, rules)
    names = axis_names(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    if not data_axes:
        return base
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in data_axes)
    data = data_axes if len(data_axes) > 1 else data_axes[0]

    def fn(shape, spec):
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, n in enumerate(shape):
            if dims[i] is None and n % dp == 0 and n >= dp:
                dims[i] = data
                return P(*dims)
        return P(*dims)

    return {n: fn(shapes[n], base[n]) for n in shapes}


def distribute_params(model: nn.Module, shardings: dict[str, NamedSharding]
                      ) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor parameter with its
    sharding (each rank keeps its shard of the whole tensor it holds), in
    place; ``requires_grad`` is kept."""
    for name, p in list(model.named_parameters()):
        mod, _, attr = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        owner.register_parameter(attr, nn.Parameter(
            distribute(p.detach(), shardings[name]),
            requires_grad=p.requires_grad))
    return model


def distribute_opt_state(opt_state: dict,
                         shardings: dict[str, NamedSharding]) -> dict:
    """``train.optimizer.init_opt_state``'s moments as DTensors on
    ``shardings`` (the ZeRO specs' NamedShardings, by parameter name); the
    step stays a plain (replicated) tensor."""
    return {**opt_state,
            **{part: {n: distribute(t, shardings[n])
                      for n, t in opt_state[part].items()}
               for part in ("mu", "nu")}}
