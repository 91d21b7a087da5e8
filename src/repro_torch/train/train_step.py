"""train_step: microbatched gradient accumulation and the AdamW + WSD
update, the port's copy of ``repro.train.train_step``.

The reference scans over microbatches so the activation working set is one
microbatch; here a Python loop runs a forward and a backward a microbatch
(``torch.autograd.grad``) and adds its gradients into a float32
accumulator, which with per-block remat bounds device memory at any global
batch.

Sharded training passes DTensor parameters (``distributed.sharding.
distribute_params``), a batch of DTensors and optimizer state in the ZeRO
specs, and runs inside ``use_rules``; ``grad_pspecs`` (the ZeRO specs) then
place the float32 accumulator, so each microbatch's gradients
reduce-scatter over the data axes instead of staying replicated.  Pipeline
parallelism is ``distributed.pipeline``; ``pipeline_train_step`` is a stub
in both packages.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import placements
from ..kernels import resolve_device
from ..models import ModelConfig, encdec_loss, init_encdec, init_lm, lm_loss
from .optimizer import OptConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 16        # grad-accumulation steps per train step
    aux_weight: float = 0.01
    opt: OptConfig = OptConfig()


def _loss_fn(params: nn.Module, batch: dict, cfg: ModelConfig,
             aux_weight: float):
    if cfg.is_encdec:
        return encdec_loss(params, batch["frames"], batch["tokens"], cfg)
    return lm_loss(params, batch["tokens"], cfg, aux_weight)


def _micro_parts(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """(B, ...) -> n microbatches of (B/n, ...): microbatch i holds rows
    [i*B/n, (i+1)*B/n), as the reference's reshape to (n, B/n, ...) does.
    A DTensor sharded on its batch dim is made whole over those mesh dims
    (an all-gather of the batch) and each microbatch sharded back, so its
    MoE router groups and capacity are the unsharded step's."""
    per = x.shape[0] // n
    if not (isinstance(x, DTensor) and Shard(0) in x.placements):
        return [x[i * per:(i + 1) * per] for i in range(n)]
    mesh, pl = x.device_mesh, x.placements
    x = x.redistribute(mesh, tuple(Replicate() if p == Shard(0) else p
                                   for p in pl))
    return [x[i * per:(i + 1) * per].redistribute(mesh, pl)
            for i in range(n)]


def _split_micro(batch: dict, n: int) -> list[dict]:
    """A batch -> n microbatches (``_micro_parts`` of every entry)."""
    parts = {k: _micro_parts(x, n) for k, x in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _constrain(g: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor gradient redistributed to ``spec``; anything else as it
    is."""
    if spec is None or not isinstance(g, DTensor):
        return g
    return g.redistribute(g.device_mesh, placements(spec, g.device_mesh))


def accumulate_grads(params: nn.Module, batch: dict, cfg: ModelConfig,
                     tcfg: TrainConfig, grad_pspecs: dict | None = None
                     ) -> tuple[dict, dict]:
    """A forward and a backward a microbatch; returns (mean gradients
    float32 by parameter name, {"loss": mean loss}).  ``grad_pspecs``
    ({name: spec}, ZeRO-2): the accumulator of a DTensor parameter takes
    that spec's placements."""
    named = list(params.named_parameters())
    specs = [(grad_pspecs or {}).get(n) for n, _ in named]
    acc: list[torch.Tensor] | None = None
    loss_sum = None
    for mb in _split_micro(batch, tcfg.microbatches):
        total, metrics = _loss_fn(params, mb, cfg, tcfg.aux_weight)
        grads = torch.autograd.grad(total, [p for _, p in named])
        with torch.no_grad():
            if acc is None:      # 0 + g, as the reference's zero start
                acc = [_constrain(g.float(), s)    # fresh: ours to add to
                       for g, s in zip(grads, specs)]
            else:
                for a, g, s in zip(acc, grads, specs):
                    a.add_(_constrain(g, s))
            loss = metrics["loss"].detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        del total, metrics, grads
    inv = 1.0 / tcfg.microbatches
    with torch.no_grad():
        for a in acc:
            a.mul_(inv)
    return {n: a for (n, _), a in zip(named, acc)}, {"loss": loss_sum * inv}


def train_step(params: nn.Module, opt_state: dict, batch: dict,
               cfg: ModelConfig, tcfg: TrainConfig,
               grad_pspecs: dict | None = None):
    """One full step, in place: returns (params, opt_state, {"loss", "lr",
    "grad_norm"}), the metrics float32 tensors on the device."""
    grads, metrics = accumulate_grads(params, batch, cfg, tcfg, grad_pspecs)
    params, opt_state, opt_metrics = adamw_update(tcfg.opt, params, grads,
                                                  opt_state)
    metrics.update(opt_metrics)
    return params, opt_state, metrics


def make_train_state(cfg: ModelConfig, seed: int = 0,
                     device: str | torch.device | None = None):
    """A seeded model with ``requires_grad`` on, and its optimizer state."""
    dev = resolve_device(device)
    params = (init_encdec if cfg.is_encdec else init_lm)(cfg, seed, dev)
    params.requires_grad_(True)
    return params, init_opt_state(params)


# ---------------------------------------------------------------------------
# pipeline parallelism over the pod axis (GPipe-style)
# ---------------------------------------------------------------------------


def pipeline_train_step(params_stages, opt_state, batch, cfg: ModelConfig,
                        tcfg: TrainConfig, mesh, n_stages: int):
    """Layers split into ``n_stages`` groups mapped over the 'pod' mesh
    axis, microbatches streamed through the stages.  A stub, as the
    reference's is: the pipelined loss and its gradients are
    ``distributed.pipeline.pipeline_loss``."""
    raise NotImplementedError(
        "pipeline parallelism runs through distributed.pipeline."
        "pipeline_loss (GPipe over the 'pod' axis)")
