"""End-to-end driver of the PyTorch port: train a reduced arch with the full
loop (deterministic data pipeline, WSD schedule, async atomic checkpoints,
NaN rollback), then reload the newest checkpoint and serve a few tokens
from it.  The port's counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--arch qwen2-1.5b] \\
        [--steps 200] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import resolve_device  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import lm_prefill  # noqa: E402
from repro_torch.serve.serve_step import serve_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault import FaultConfig  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_state)


def main(argv: list[str] | None = None) -> list[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit(f"{args.arch}: the example serves a decoder-only "
                         f"LM (lm_prefill / serve_step)")
    tcfg = TrainConfig(
        microbatches=2,
        opt=OptConfig(peak_lr=3e-3, warmup_steps=20,
                      stable_steps=max(args.steps - 60, 20),
                      decay_steps=40, schedule="wsd"))
    dcfg = DataConfig(seq_len=64, global_batch=8, vocab_size=cfg.vocab_size)
    fcfg = FaultConfig(checkpoint_every=50)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
        report = train_loop(cfg, tcfg, dcfg, fcfg, steps=args.steps,
                            ckpt_dir=ckpt_dir, log_every=25, device=dev)
        print(f"training done: {report}")

        # reload the final checkpoint and decode a few tokens
        params, opt = make_train_state(cfg, 0, dev)
        step = ckpt.latest_step(ckpt_dir)
        ckpt.restore(ckpt_dir, step, params, opt)
    params.requires_grad_(False)
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)),
        device=dev)
    with torch.inference_mode():
        logits, caches = lm_prefill(params, prompt, cfg, max_seq=32)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        clen = torch.tensor([8], device=dev)
        generated = [int(tok[0, 0])]
        for _ in range(8):
            tok, caches, _ = serve_step(params, tok, caches, clen, cfg)
            clen = clen + 1
            generated.append(int(tok[0, 0]))
    print(f"checkpoint step {step} -> greedy decode: {generated}")
    return generated


if __name__ == "__main__":
    main()
