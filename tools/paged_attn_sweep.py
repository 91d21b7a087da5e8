#!/usr/bin/env python3
"""Sweep the paged-attention kernels' two tuning choices on the card: the
split plan's pages per chunk and the cp.async ring's stages per warp.

    python3 tools/paged_attn_sweep.py

The split kernel is built three times from copies of
``src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu`` with ``kStages``
set to 2, 3 and 4 (into ``build/torch_ext/``).  Each build is loaded in
place of the package's library and timed in turns (2, 3, 4, 2 stages, two
rounds) on qwen2-1.5b's heads in bf16: at batch 8 with lengths up to 32768
tokens (the repo's decode_32k context) at the plan's chunk and at chunks
of 1-32 pages, and at 230 tokens, batch 1, at the plan's chunk (one page).
Each line gives the device time per wrapper call of the split and the
combine kernel (profiler, mean over the calls; chip_smoke.py's timing)
beside the byte bound.
Every build's output is held against the 2-stage build's.  Prints the
card's name and power limit first.
"""

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attn import kernel as pk  # noqa: E402

STAGES = (2, 3, 4)
LONG_CHUNKS = (None, 1, 2, 4, 8, 11, 16, 32)


def inputs(dev, seed: int, lens):
    """qwen2-1.5b's heads in bf16, 64-token pages, permuted block tables
    with -1 tails, as chip_smoke.py draws them."""
    q = cs.QWEN2
    return cs._attn_inputs(seed, len(lens), q.n_heads, q.n_kv_heads,
                           q.head_dim, cs.PAGE, -(-max(lens) // cs.PAGE),
                           torch.bfloat16, dev, lens=lens)


def build(stages: int):
    """The library with kStages = stages, built from a copy of the
    source."""
    src = pk.CSRC / "paged_attn.cu"
    text = src.read_text()
    line = "constexpr int kStages = 2;"
    if line not in text:
        raise RuntimeError(f"{src} no longer sets `{line}`")
    d = _build.BUILD_DIR / f"paged_attn_stages{stages}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "paged_attn.cu").write_text(
        text.replace(line, f"constexpr int kStages = {stages};"))
    lib = ctypes.CDLL(str(_build.build(f"paged_attn_s{stages}", d).path))
    for fn in (lib.paged_attn_f32, lib.paged_attn_bf16):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.paged_attn_error_string.argtypes = [ctypes.c_int]
    lib.paged_attn_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("paged_attn_sweep: no CUDA device")
    cs.phase_device()
    dev = torch.device("cuda", 0)
    libs = {s: build(s) for s in STAGES}
    lens = np.random.default_rng(32).integers(1, 32769, 8)
    lens[0] = 32768
    cases = [("batch 8 up to 32768", inputs(dev, 32, lens.tolist()),
              LONG_CHUNKS, 20),
             ("230 tokens", inputs(dev, 5, [230]), (None,), 200)]
    want = {}
    for rnd in range(2):
        for stages in STAGES + (STAGES[0],):
            pk._lib = libs[stages]
            for name, x, chunks, reps in cases:
                sl = x[4]
                bound = pk.work_bytes(sl, 2, 6, 128, cs.PAGE, 2) / \
                    cs.HBM_BYTES_PER_S * 1e3
                for chunk in chunks:
                    t = cs._attn_tables(x, chunk)
                    fn = lambda: cs.pops.paged_decode_attention(  # noqa
                        *x[:3], tables=t)
                    out = fn()
                    key = (name, chunk)
                    if key not in want:
                        want[key] = out
                    elif not torch.allclose(out, want[key], rtol=1e-5,
                                            atol=1e-6):
                        raise AssertionError(f"{stages} stages differ at "
                                             f"{key}")
                    ms = cs._call_kernels_ms(fn, "paged_attn", reps) or \
                        {"call (events)": cs._device_ms(fn, reps)}
                    total = sum(ms.values())
                    print(f"round {rnd} stages {stages} {name}: chunk "
                          f"{t.chunk_pages}{' (plan)' if chunk is None else ''}"
                          f", {t.n_items} chunks: {total:.5f} ms ("
                          + ", ".join(f"{k} {v:.5f}" for k, v in ms.items())
                          + f"), {bound / total:.3f} of the byte bound",
                          flush=True)


if __name__ == "__main__":
    main()
