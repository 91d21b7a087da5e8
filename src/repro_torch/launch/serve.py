"""Serving launcher: prefill + decode with the continuous batcher (the
port's copy of ``repro.launch.serve``), for every arch of
``configs.ARCHS``: the ATTN stacks (dense, MoE, and the VLM and audio
backbones, which the reference's CLI serves through ``init_lm`` as well),
xLSTM and the Mamba2 hybrid.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        [--reduced] [--requests 4 --prompt-len 16 --max-new 8] [--paged] \
        [--device cpu]

--paged decodes through the paged KV cache, whose attention runs the
paged-attention kernel (``kernels/paged_attn``; every attention
application: each layer of an ATTN stack, each of the hybrid's shared-block
applications), and prints the MAGE page schedule stats for the run; an
attention-free model (xLSTM) decodes on its states and makes no paged
call.  An int8 KV cache (``cfg.kv_cache_dtype``) has no paged decode and
raises under --paged.  Without --paged decode attends over a contiguous,
padded cache.  The model's weights are seeded random numbers: the
repository holds no checkpoint.  It runs on the card unless ``--device
cpu`` is given, which runs the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..kernels import resolve_device
from ..models import PagedCaches, init_lm
from ..models.lm import attention_kv, check_supported, recurrent_states
from ..serve.paged_kv import PagedKVCache, PagedKVConfig, plan_kv_schedule
from ..serve.serve_step import Batcher, Request, prefill_step, serve_step


@dataclasses.dataclass
class ServeStats:
    decode_tokens: int        # tokens made by decode steps
    seconds: float            # the serving loop: prefill and decode
    prefill_tokens: int
    prefill_s: float          # prefill and its first token, synchronised
    decode_s: float
    kv_plan: dict | None = None   # the paged run's KV page plan stats


def _kv_plan(max_seq: int) -> dict:
    """The reference's page-schedule report for a decode of max_seq
    tokens (its page size and budget rule)."""
    page = max(min(64, max_seq // 8), 1)
    n_pages = (max_seq + page - 1) // page
    _, rep = plan_kv_schedule(total_tokens=max_seq, page_size=page,
                              hbm_pages=max(n_pages // 2, 4), lookahead=4,
                              prefetch=2)
    return {"page_size": page, "swap_ins": rep.replacement.swap_ins,
            "swap_outs": rep.replacement.swap_outs,
            "prefetched": rep.schedule.prefetched,
            "sync_fallbacks": rep.schedule.sync_fallbacks}


def paged_cache(cfg, caches, max_seq: int) -> PagedCaches:
    """The caches of a paged decode after ``lm_prefill``'s (unpadded)
    ``caches``: a fresh paged cache with room for max_seq tokens a sequence
    in 64-token pages (``PagedKVConfig``'s default), one layer an attention
    application (every layer of an ATTN stack, the hybrid's shared-block
    applications), holding the prompt's K/V; and the recurrent states of
    the prefill's tree.  An attention-free model has no paged cache.  An
    int8 KV cache raises ``ValueError``: the paged kernel takes float32 or
    bfloat16 pages."""
    check_supported(cfg, True)
    states = recurrent_states(cfg, caches)
    kvs = attention_kv(cfg, caches)
    if kvs is None:
        return PagedCaches(None, states)
    k, v = kvs
    kv = PagedKVConfig()
    kv = dataclasses.replace(kv, max_pages_per_seq=-(-max_seq //
                                                     kv.page_size))
    batch = k.shape[1]
    cache = PagedKVCache(kv, batch * kv.max_pages_per_seq, batch,
                         cfg.n_kv_heads, cfg.head_dim, k.dtype,
                         n_layers=k.shape[0], device=k.device)
    for seq in range(batch):
        cache.write_prefill(seq, k[:, seq], v[:, seq])
    return PagedCaches(cache, states)


def run_server(cfg, requests: list[Request], batch_size: int, max_seq: int,
               paged: bool = False, params=None,
               device: str | torch.device | None = None) -> ServeStats:
    """Serve ``requests`` greedily, each one prefilled and decoded to
    ``max_new`` tokens with a fresh cache (batch of 1, as the reference
    does); tokens land in ``req.output``.  ``params`` is an ``LM`` (the
    tests pass the reference's weights); without it the seeded model is
    built on ``device`` from seed 0.  ``paged`` decodes through a
    :func:`paged_cache` (an int8 KV cache raises ``ValueError``)."""
    check_supported(cfg, paged)
    if params is None:
        params = init_lm(cfg, 0, resolve_device(device))
    dev = params.device
    batcher = Batcher(batch_size)
    for r in requests:
        batcher.submit(r)
    total_tokens = prefill_tokens = 0
    prefill_s = decode_s = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode():
        while batcher.busy():
            batcher.fill()
            for i, req in enumerate(batcher.active):
                if req is None:
                    continue
                t1 = time.perf_counter()
                toks = torch.as_tensor(np.asarray(req.prompt),
                                       dtype=torch.int64, device=dev)[None]
                plen = toks.shape[1]
                logits, caches = prefill_step(
                    params, toks, cfg, max_seq=plen if paged else max_seq)
                nxt = int(torch.argmax(logits[0, -1]))
                prefill_s += time.perf_counter() - t1
                prefill_tokens += plen
                t1 = time.perf_counter()
                req.output.append(nxt)
                if paged:
                    caches, clen = paged_cache(cfg, caches, max_seq), None
                else:
                    clen = torch.tensor([plen], device=dev)
                token = torch.tensor([[nxt]], device=dev)
                while len(req.output) < req.max_new:
                    token, caches, _ = serve_step(params, token, caches,
                                                  clen, cfg)
                    if clen is not None:
                        clen = clen + 1
                    req.output.append(int(token[0, 0]))
                    total_tokens += 1
                decode_s += time.perf_counter() - t1
                req.done = True
                batcher.retire(i)
    stats = ServeStats(total_tokens, time.perf_counter() - t0,
                       prefill_tokens, prefill_s, decode_s)
    if paged:
        stats.kv_plan = _kv_plan(max_seq)
        print(f"paged-KV plan: swaps in/out = {stats.kv_plan['swap_ins']}/"
              f"{stats.kv_plan['swap_outs']}, prefetched="
              f"{stats.kv_plan['prefetched']}, sync_fallbacks="
              f"{stats.kv_plan['sync_fallbacks']}")
    return stats


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    st = run_server(cfg, reqs, batch_size=2,
                    max_seq=args.prompt_len + args.max_new + 1,
                    paged=args.paged, device=args.device)
    print(f"served {args.requests} requests, {st.decode_tokens} decode "
          f"tokens in {st.seconds:.2f}s (prefill {st.prefill_s:.2f}s, "
          f"decode {st.decode_s:.2f}s)")


if __name__ == "__main__":
    main()
