"""Serving steps: prefill and decode, batched requests (the port's copy of
``repro.serve.serve_step``).

``serve_step`` = one decode step (one new token for every sequence in the
batch against its KV cache, contiguous or paged).  ``prefill_step``
processes the full prompt.  Sampling is greedy, or at a temperature through
an explicit ``torch.Generator``; the batcher groups requests to the
model's batch size.  ``serve_step_encdec`` is the encoder-decoder's step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..distributed.sharding import shard
from ..models import ModelConfig, encdec_decode, lm_decode, lm_prefill


def _whole_vocab(last: torch.Tensor) -> torch.Tensor:
    """Last-position logits (b, v) with the vocab whole on every rank
    (sampling reads the whole row; a plain tensor passes as it is)."""
    return shard(last, "batch", None)


def prefill_step(params, tokens: torch.Tensor, cfg: ModelConfig,
                 max_seq: int):
    """Prompt processing; returns (next-token logits, caches)."""
    return lm_prefill(params, tokens, cfg, max_seq)


def serve_step(params, token: torch.Tensor, caches,
               cache_len: torch.Tensor | None, cfg: ModelConfig,
               temperature: float = 0.0,
               generator: torch.Generator | None = None):
    """One decode step; returns (next token ids (b, 1) int64, caches,
    logits)."""
    logits, caches = lm_decode(params, token, caches, cache_len, cfg)
    last = _whole_vocab(logits[:, -1])
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(last / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)
    else:
        nxt = torch.argmax(last, dim=-1)[:, None]
    return nxt, caches, logits


def serve_step_encdec(params, token: torch.Tensor, memory: torch.Tensor,
                      caches, cache_len: torch.Tensor, cfg: ModelConfig):
    """One greedy decoder step of the encoder-decoder; returns (next token
    ids (b, 1) int64, caches, logits)."""
    logits, caches = encdec_decode(params, token, memory, caches, cache_len,
                                   cfg)
    nxt = torch.argmax(_whole_vocab(logits[:, -1]), dim=-1)[:, None]
    return nxt, caches, logits


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any            # np.ndarray of token ids
    max_new: int = 16
    done: bool = False
    output: list = dataclasses.field(default_factory=list)


class Batcher:
    """Greedy static batcher: fills slots with pending requests; a slot
    frees when its request finishes (continuous batching lite)."""

    def __init__(self, batch_size: int):
        self.batch = batch_size
        self.pending: list[Request] = []
        self.active: list[Request | None] = [None] * batch_size

    def submit(self, req: Request):
        self.pending.append(req)

    def fill(self) -> list[tuple[int, Request]]:
        placed = []
        for i in range(self.batch):
            if self.active[i] is None and self.pending:
                self.active[i] = self.pending.pop(0)
                placed.append((i, self.active[i]))
        return placed

    def retire(self, i: int):
        self.active[i] = None

    def busy(self) -> bool:
        return any(self.active) or bool(self.pending)
