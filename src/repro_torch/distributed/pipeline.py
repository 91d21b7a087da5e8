"""GPipe-style pipeline parallelism over the pod axis (differentiable): the
port's copy of ``repro.distributed.pipeline``.

Each pod holds a contiguous stage of layers; microbatch activations flow
stage to stage through ``torch.distributed.pipelining`` (``PipelineStage``
and ``ScheduleGPipe``: every microbatch's forward, then every backward),
whose schedule carries the gradients back through the stages; plain
``send`` / ``recv`` are not differentiable.  The reference gets its
backward from ``jax.grad`` through ``ppermute`` over n_micro + n_stages - 1
ticks.

Applies to single-scan ATTN layouts (dense, MoE, VLM), as the reference's
does; embed and the final norm are replicated across stages (their
gradients summed over the stages that use them).  The loss is averaged over
microbatches, then over ``data``; the MoE aux loss is dropped, as the
reference drops ``block_train``'s.  Activations cross stages on the
process group's device: under gloo, which carries CPU tensors only, a
stage on a card stages them through host memory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.pipelining import PipelineStage, ScheduleGPipe

from ..models.blocks import BlockKind
from ..models.layers import embed, rmsnorm, unembed
from ..models.lm import LM, grouped_layout, next_token_nll
from .sharding import AxisRules, params_pspecs


class Stage(nn.Module):
    """Stage ``index`` of ``n_stages``: the LM's blocks ``[index * L / S,
    (index + 1) * L / S)``, and the embedding and final norm (the same
    parameters as the LM's, so gradients land on it).  The first stage
    takes token ids, the others hidden states; the last returns float32
    logits."""

    def __init__(self, params: LM, index: int, n_stages: int):
        super().__init__()
        per = len(params.blocks) // n_stages
        self.cfg = params.cfg
        self.index, self.n_stages = index, n_stages
        self.lo, self.hi = index * per, (index + 1) * per
        self.embed = params.embed
        self.blocks = nn.ModuleList(params.blocks[self.lo:self.hi])
        self.final_norm = params.final_norm

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        io = x.device
        x = x.to(self.device)
        if self.index == 0:
            x = embed(self.embed, x)
        for blk in self.blocks:
            x, _ = blk(x)          # the MoE aux loss is dropped
        if self.index == self.n_stages - 1:
            x = unembed(self.embed,
                        rmsnorm(self.final_norm, x, self.cfg.norm_eps))
        return x.to(io)


def split_stage_params(params: LM, n_stages: int) -> list[Stage]:
    """The LM's layers in ``n_stages`` contiguous stages (the reference's
    (L, ...) -> (n_stages, L / S, ...) reshape of its one scanned stack)."""
    groups = grouped_layout(params.cfg)
    if len(groups) != 1 or groups[0][0] != "scan" \
            or groups[0][1] != BlockKind.ATTN:
        raise ValueError(f"{params.cfg.name}: the pipeline takes one ATTN "
                         f"scan group, not {groups}")
    if len(params.blocks) % n_stages:
        raise ValueError(f"{len(params.blocks)} layers do not split into "
                         f"{n_stages} stages")
    return [Stage(params, i, n_stages) for i in range(n_stages)]


def stage_param_specs(params: LM, n_stages: int, rules: AxisRules) -> dict:
    """{parameter name: (stage, spec)}: a block's parameters belong to the
    stage holding it (the reference's stage stacks sharded over 'pod' on
    their leading dim), the embedding and final norm to every stage
    (None, replicated); the spec is the parameter's own."""
    per = len(params.blocks) // n_stages
    out = {}
    for name, spec in params_pspecs(params, rules).items():
        stage = int(name.split(".")[1]) // per \
            if name.startswith("blocks.") else None
        out[name] = (stage, spec)
    return out


def _group(mesh, axis: str):
    return mesh.get_group(axis) if axis in mesh.mesh_dim_names else None


def _coord(mesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def _size(mesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def pipeline_loss(stages: list[Stage], tokens: torch.Tensor, cfg, mesh,
                  n_micro: int, rules: AxisRules | None = None
                  ) -> torch.Tensor:
    """Pipelined forward, loss and backward over ``mesh``'s 'pod' axis.

    ``stages`` is ``split_stage_params`` of one LM on every rank;
    ``tokens`` (B, S) the whole batch, the same on every rank: the ranks of
    the 'data' axis take its rows in B / dp blocks, split into ``n_micro``
    microbatches.  Runs every microbatch's forward and backward, leaves
    this rank's gradients in ``.grad`` (its stage's blocks, the embedding
    and the final norm, summed over the stages and averaged over 'data')
    and returns the loss: the mean of the microbatches' next-token losses,
    averaged over 'data', on every rank.  ``rules`` is accepted for the
    reference's signature; the stages hold plain (unsharded) tensors."""
    n_stages = _size(mesh, "pod")
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages on a pod axis of "
                         f"{n_stages}")
    idx = _coord(mesh, "pod")
    stage = stages[idx]
    pod, data = _group(mesh, "pod"), _group(mesh, "data")
    dp = _size(mesh, "data")
    rows = tokens.shape[0] // dp
    local = tokens[_coord(mesh, "data") * rows:][:rows]
    io = torch.device("cpu") if dist.get_backend(pod) == "gloo" \
        else stage.device
    pipe = PipelineStage(stage, idx, n_stages, io, group=pod)
    sched = ScheduleGPipe(pipe, n_micro, loss_fn=next_token_nll)
    first, last = idx == 0, idx == n_stages - 1
    args = (local[:, :-1].to(io),) if first else ()
    losses: list = []
    kwargs = {"target": local[:, 1:].to(io), "losses": losses} if last \
        else {}
    sched.step(*args, **kwargs)
    loss = torch.stack(losses).mean().float() if last else \
        torch.zeros((), dtype=torch.float32, device=io)
    loss = loss.to(io)
    dist.all_reduce(loss, group=pod)
    if data is not None:
        dist.all_reduce(loss, group=data)
        loss /= dp
    # the replicated parameters' gradients: summed over the stages that
    # use them; then every gradient averaged over 'data'
    shared = list(stage.embed.parameters()) + \
        list(stage.final_norm.parameters())
    for p in stage.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad.to(io)
        if any(p is q for q in shared):
            dist.all_reduce(g, group=pod)
        if data is not None:
            dist.all_reduce(g, group=data)
            g /= dp
        p.grad.copy_(g)
    return loss
