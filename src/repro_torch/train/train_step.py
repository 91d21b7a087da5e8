"""train_step: microbatched gradient accumulation and the AdamW + WSD
update, the port's copy of ``repro.train.train_step``.

The reference scans over microbatches so the activation working set is one
microbatch; here a Python loop runs a forward and a backward a microbatch
(``torch.autograd.grad``) and adds its gradients into a float32
accumulator, which with per-block remat bounds device memory at any global
batch.  On one card there is no mesh: the reference's sharding constraints
(``grad_pspecs``) are dropped, and pipeline parallelism
(``pipeline_train_step``) is a stub in both packages.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

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


def _split_micro(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n microbatches of (B/n, ...), in order."""
    out = []
    for i in range(n):
        mb = {}
        for k, x in batch.items():
            per = x.shape[0] // n
            mb[k] = x[i * per:(i + 1) * per]
        out.append(mb)
    return out


def accumulate_grads(params: nn.Module, batch: dict, cfg: ModelConfig,
                     tcfg: TrainConfig) -> tuple[dict, dict]:
    """A forward and a backward a microbatch; returns (mean gradients
    float32 by parameter name, {"loss": mean loss})."""
    named = list(params.named_parameters())
    acc: list[torch.Tensor] | None = None
    loss_sum = None
    for mb in _split_micro(batch, tcfg.microbatches):
        total, metrics = _loss_fn(params, mb, cfg, tcfg.aux_weight)
        grads = torch.autograd.grad(total, [p for _, p in named])
        with torch.no_grad():
            if acc is None:      # 0 + g, as the reference's zero start
                acc = [g.float() for g in grads]     # fresh: ours to add to
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            loss = metrics["loss"].detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        del total, metrics, grads
    inv = 1.0 / tcfg.microbatches
    with torch.no_grad():
        for a in acc:
            a.mul_(inv)
    return {n: a for (n, _), a in zip(named, acc)}, {"loss": loss_sum * inv}


def train_step(params: nn.Module, opt_state: dict, batch: dict,
               cfg: ModelConfig, tcfg: TrainConfig):
    """One full step, in place: returns (params, opt_state, {"loss", "lr",
    "grad_norm"}), the metrics float32 tensors on the device."""
    grads, metrics = accumulate_grads(params, batch, cfg, tcfg)
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
    """Layers split into ``n_stages`` groups, microbatches streamed through
    the stages.  A stub, as the reference's is (ROADMAP Queue 1 item 14)."""
    raise NotImplementedError(
        "pipeline parallelism is not ported (ROADMAP.md Queue 1 item 14)")
