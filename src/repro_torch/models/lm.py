"""The causal LM of every decoder-only family: init, the training forward
and loss, prefill and decode (``repro.models.lm``'s ``grouped_layout``,
``init_lm``, ``lm_forward``, ``lm_loss``, ``init_caches``, ``lm_prefill``,
``lm_decode``) for the dense, MoE, VLM and audio backbones (ATTN stacks),
xLSTM and the Mamba2 hybrid.

The reference scans stacked parameter trees over its layout's groups; here
:class:`LM` holds a ``ModuleList`` of every layer's block in layer order
(``blocks.<i>``) and, for the hybrid, the one shared attention block
(``shared_attn``), and the layer loop is a Python loop over
:func:`applications`.  Weights are seeded on the target device (a
``torch.Generator`` there, drawn in a fixed order with the reference's init
scales); they are not the reference's numbers for the same seed, so tests
carry the reference's weights across (``interop.lm_params_from_jax``).
Every parameter is made with ``requires_grad=False``, so serving builds no
autograd graph; ``train.train_step.make_train_state`` turns it on for the
model it trains.  The hybrid's shared block is one module applied at each
of its applications, so its gradient sums over them.

The caches are the reference's tree: a list with one entry a group of
:func:`grouped_layout`; a ``("scan", kind, count)`` group holds its kind's
cache stacked over ``count`` (attention: ``(k, v)``, or the int8 ``(k_q,
v_q, k_scale, v_scale)``; Mamba2 ``{"h", "conv"}``; mLSTM ``{"C", "n",
"m"}``; sLSTM ``{"c", "n", "h", "m"}``), a ``("rep", segments, n_rep)``
group a dict ``seg<j>`` of each segment's cache stacked over ``(n_rep,
count)``.  Decode updates them in place.  A paged decode takes a
:class:`PagedCaches` (or, for an ATTN stack, a bare
``serve.paged_kv.PagedKVCache``): the attention applications' K/V in one
paged cache, whose attention goes through the paged-attention kernel, and
the recurrent states in the tree.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import on_shards
from ..kernels import resolve_device
from ..serve.paged_kv import PagedKVCache
from .blocks import ATTN_KINDS, Block, block_init_cache, layout
from .config import BlockKind, ModelConfig
from .layers import Embed, RMSNorm, embed, remat_call, rmsnorm, unembed

Group = tuple  # ("scan", kind, count) | ("rep", ((kind, count), ...), n_rep)


def grouped_layout(cfg: ModelConfig) -> list[Group]:
    segs = layout(cfg)
    if cfg.family == "ssm" and cfg.slstm_every:
        k = cfg.slstm_every
        n_rep = cfg.n_layers // k
        groups: list[Group] = [("rep", ((BlockKind.MLSTM, k - 1),
                                        (BlockKind.SLSTM, 1)), n_rep)]
        tail = cfg.n_layers - n_rep * k
        if tail:
            groups.append(("scan", BlockKind.MLSTM, tail))
        return groups
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        n_rep = cfg.n_layers // k
        groups = [("rep", ((BlockKind.MAMBA2, k),
                           (BlockKind.SHARED_ATTN, 1)), n_rep)]
        tail = cfg.n_layers - n_rep * k
        if tail:
            groups.append(("scan", BlockKind.MAMBA2, tail))
        return groups
    return [("scan", k, c) for k, c in segs]


@dataclasses.dataclass(frozen=True)
class Application:
    """One block application in layer order: its kind, its block
    (``LM.blocks[block]``; None for the shared attention block), where its
    cache sits in the tree (``caches[group]``, then ``[seg]`` in a rep
    group, then ``[index]``), and for an attention kind its layer in a
    paged cache (``attn``)."""
    kind: BlockKind
    block: int | None
    group: int
    seg: str | None
    index: tuple
    attn: int | None


def applications(cfg: ModelConfig) -> list[Application]:
    apps, block, attn = [], 0, 0
    for g, grp in enumerate(grouped_layout(cfg)):
        if grp[0] == "scan":
            runs = [(None, (c,), grp[1]) for c in range(grp[2])]
        else:
            _, inner, n_rep = grp
            runs = [(f"seg{j}", (r, c), kind) for r in range(n_rep)
                    for j, (kind, count) in enumerate(inner)
                    for c in range(count)]
        for seg, index, kind in runs:
            shared = kind == BlockKind.SHARED_ATTN
            apps.append(Application(kind, None if shared else block, g, seg,
                                    index, attn if kind in ATTN_KINDS
                                    else None))
            block += not shared
            attn += kind in ATTN_KINDS
    return apps


def check_supported(cfg: ModelConfig, paged: bool) -> None:
    """What the port cannot run: an int8 KV cache under the paged decode
    (the paged-attention kernel takes float32 or bfloat16 pages, as the
    TPU kernel does; nothing falls back to the contiguous decode)."""
    if paged and cfg.kv_cache_dtype == "int8":
        raise ValueError(f"{cfg.name}: kv_cache_dtype='int8' has no paged "
                         f"decode (the paged-attention kernel takes float32 "
                         f"or bfloat16 pages); serve it without --paged")


class LM(nn.Module):
    """Embeddings, every layer's :class:`Block`, the hybrid's shared
    attention block and the final norm."""

    #: the parameters the reference stacks over its layout's layer axes
    #: (``train.optimizer`` decays by the reference's ranks)
    stacked_prefixes = ("blocks.",)

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.apps = applications(cfg)
        self.embed = Embed(cfg, gen)
        self.blocks = nn.ModuleList(Block(cfg, gen, a.kind) for a in self.apps
                                    if a.block is not None)
        if cfg.shared_attn_every:
            self.shared_attn = Block(cfg, gen, BlockKind.SHARED_ATTN)
        self.final_norm = RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def block(self, app: Application) -> Block:
        return self.shared_attn if app.block is None else \
            self.blocks[app.block]


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: str | torch.device | None = None) -> LM:
    return LM(cfg, seed, device)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------


REMAT_POLICIES = ("full", "dots", "block_outs")

_ACTIVE_REMAT_POLICY = ["full"]

#: the products whose outputs the "dots" policy saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def set_remat_policy(name: str) -> None:
    """What a checkpointed block keeps for its backward pass (the
    reference's policies): "full" keeps its input and recomputes the rest;
    "dots" keeps every matmul output (selective activation checkpointing);
    "block_outs" keeps an attention block's post-attention and post-MLP
    residual outputs (the block is checkpointed as two halves) and
    recomputes the rest locally.  The hybrid's shared attention block stays
    "full", as in the reference."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat policy {name!r} is not one of "
                         f"{REMAT_POLICIES}")
    _ACTIVE_REMAT_POLICY[0] = name


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: Block, x: torch.Tensor, remat: bool, shared: bool):
    """``block(x)`` under the active remat policy (``shared``: the
    hybrid's shared block, always "full")."""
    policy = "full" if shared else _ACTIVE_REMAT_POLICY[0]
    if policy == "full" or not (remat and torch.is_grad_enabled()):
        return remat_call(block, x, remat=remat)
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint,
                             use_reentrant=False)
    if policy == "dots":
        return ckpt(block, x, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    if block.kind in ATTN_KINDS:
        return ckpt(block.mlp_half, ckpt(block.attn_half, x))
    return ckpt(block, x)


def lm_forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
               remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) -> (logits (b, s, v) f32, aux loss f32).  With
    ``remat`` every block application is checkpointed under the active
    policy (:func:`set_remat_policy`); the aux loss sums the MoE blocks'
    load-balancing terms."""
    x = embed(params.embed, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for app in params.apps:
        x, a = _remat_block(params.block(app), x, remat, app.block is None)
        aux = aux + a
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x), aux


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """The mean next-token cross entropy of logits (b, s, v) against
    targets (b, s).  DTensor logits: each rank takes its batch rows, the
    vocab made whole (``distributed.sharding.on_shards``)."""
    if isinstance(logits, DTensor):
        nll = on_shards(_nll, ((logits, ("b", None, None)),
                               (targets, ("b", None))), ("b", None))
        return nll.mean()
    return _nll(logits, targets).mean()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def lm_loss(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
            aux_weight: float = 0.01, remat: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy over tokens (b, s): (loss + aux_weight *
    aux, {"loss", "aux", "ppl_proxy"})."""
    logits, aux = lm_forward(params, tokens[:, :-1], cfg, remat)
    loss = next_token_nll(logits, tokens[:, 1:])
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


def _map(fn, tree):
    """Apply ``fn`` to every tensor of one block's cache (a tuple or a
    dict)."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return tuple(fn(v) for v in tree)


def _stack(caches: list, shape: tuple):
    """Per-application caches of one group or segment, in layer order ->
    one cache stacked over ``shape``."""
    first = caches[0]
    keys = first.keys() if isinstance(first, dict) else range(len(first))
    out = {k: torch.stack([c[k] for c in caches]).reshape(
        shape + first[k].shape) for k in keys}
    return out if isinstance(first, dict) else tuple(out.values())


def _slot(caches, app: Application):
    """The stacked cache of ``app``'s group or segment."""
    grp = caches[app.group]
    return grp if app.seg is None else grp[app.seg]


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: str | torch.device | None = None) -> list:
    dev = resolve_device(device)
    caches = []
    for grp in grouped_layout(cfg):
        if grp[0] == "scan":
            _, kind, count = grp
            one = block_init_cache(cfg, kind, batch, max_seq, dev)
            caches.append(_map(lambda t: t.expand((count,) + t.shape)
                               .contiguous(), one))
        else:
            _, inner, n_rep = grp
            gc = {}
            for j, (kind, count) in enumerate(inner):
                one = block_init_cache(cfg, kind, batch, max_seq, dev)
                gc[f"seg{j}"] = _map(lambda t: t.expand(
                    (n_rep, count) + t.shape).contiguous(), one)
            caches.append(gc)
    return caches


def lm_prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
               max_seq: int):
    """Prefill a prompt; returns (last-token logits (b, 1, v) f32, caches
    padded to max_seq)."""
    x = embed(params.embed, tokens)
    runs: dict = {}      # (group, seg) -> its caches in layer order
    last: dict = {}      # (group, seg) -> its last application
    for app in params.apps:
        x, c = params.block(app).prefill(x, max_seq)
        runs.setdefault((app.group, app.seg), []).append(c)
        last[app.group, app.seg] = app
    caches: list = [None] * len(grouped_layout(cfg))
    for (g, seg), cs in runs.items():
        # the last application's index + 1 is the stack's shape:
        # (count,) in a scan group, (n_rep, count) in a rep group
        stacked = _stack(cs, tuple(i + 1 for i in last[g, seg].index))
        if seg is None:
            caches[g] = stacked
        else:
            caches[g] = caches[g] or {}
            caches[g][seg] = stacked
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x[:, -1:]), caches


@dataclasses.dataclass
class PagedCaches:
    """The caches of a paged decode: every attention application's K/V in
    one paged cache (``kv``; None for an attention-free model), and the
    recurrent states in the reference's tree (``states``; None where an
    attention cache would be)."""
    kv: PagedKVCache | None
    states: list


def attention_kv(cfg: ModelConfig, caches: list):
    """Every attention application's K and V from a contiguous cache tree,
    stacked in layer order: (k, v) each (n_attn, batch, seq, kv_heads,
    head_dim); None for an attention-free model."""
    attn = [a for a in applications(cfg) if a.attn is not None]
    if not attn:
        return None
    return tuple(torch.stack([_slot(caches, a)[i][a.index] for a in attn])
                 for i in (0, 1))


def recurrent_states(cfg: ModelConfig, caches: list) -> list:
    """The cache tree with every attention cache replaced by None: what a
    paged decode keeps beside its paged cache."""
    out = []
    for grp, c in zip(grouped_layout(cfg), caches):
        if grp[0] == "scan":
            out.append(None if grp[1] in ATTN_KINDS else c)
        else:
            out.append({f"seg{j}": None if kind in ATTN_KINDS
                        else c[f"seg{j}"]
                        for j, (kind, _) in enumerate(grp[1])})
    return out


def lm_decode(params: LM, token: torch.Tensor, caches,
              cache_len: torch.Tensor | None, cfg: ModelConfig):
    """One decode step.  token (b, 1) ids; cache_len (b,) valid lengths of
    contiguous caches, which are updated in place.  A paged decode
    (:class:`PagedCaches` or a ``PagedKVCache``) keeps its own lengths
    (pass cache_len=None): the attention applications' new K/V go into its
    pages, the recurrent states are updated in place.  Returns (logits
    (b, 1, v) f32, caches)."""
    if isinstance(caches, PagedKVCache):
        kv, tree = caches, None
    elif isinstance(caches, PagedCaches):
        kv, tree = caches.kv, caches.states
    else:
        kv, tree = None, caches
    paged = tree is not caches
    if paged:
        check_supported(cfg, True)
        if cache_len is not None:
            raise ValueError("a paged cache keeps its own lengths; pass "
                             "cache_len=None")
    step = kv.append_step() if kv is not None else None
    x = embed(params.embed, token)
    for app in params.apps:
        blk = params.block(app)
        if paged and app.kind in ATTN_KINDS:
            x = blk.decode_paged(x, kv, app.attn, step)
            continue
        stacked = _slot(tree, app)
        cache = _map(lambda t: t[app.index], stacked)
        x, new = blk.decode(x, cache, cache_len)
        if app.kind not in ATTN_KINDS:     # attention writes in place
            for k, v in new.items():
                stacked[k][app.index] = v
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x), caches
