#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

It drives the port's three kernel paths: the planned two-party garbled
merge (GC) and the other GC workloads and apps, the planned CKKS jobs
(both kinds of job at four workers a party, in one process and as a fleet
of one process a rank from saved plans, and both served by the plan-cache
daemon) and serving qwen2-1.5b (and, briefly, stablelm-3b and every other
model family: MoE, the Mamba2 hybrid, xLSTM, the encoder-decoder, the
int8 KV cache and a prompt of 8192 tokens) with the paged decode; and
five paths without a kernel of their own: training (every family's
reduced config card against CPU, qwen2-1.5b at full width, checkpoints,
faults and the offload planner over its gradient), the distributed
layer (sharded training on a world of one, the pipeline as two
processes on the card, the multi-pod dry run on the host), the n-party
Shamir jobs on the card, the §8.2 scenario simulator (``bench``, host
work) and secure aggregation (its sums on the card).
TF32 stays off for the whole run: the plain versions' float32 products run
in full float32.  Phases, each raising on failure:

1. device        the card's name and power limit (nvidia-smi);
2. build         the half-gates, the NTT and the paged-attention CUDA
                 libraries from the sources in the checkout, one nvcc each,
                 all at once (ptxas' registers and spills, one line per NTT
                 kernel instantiation, the fused ntt_mul_kernel's among
                 them; the half-gates kernels' SASS counts from cuobjdump);
3. kernels       each half-gates kernel against its plain PyTorch version
                 on the card, bit for bit, at the main path's launch sizes
                 and beyond, gate ids up to 2^40, all four truth-table
                 rows; at 16, 32, 64 and 2^20 gates its device time per
                 launch (profiler), the host's time per wrapper call
                 (events), the bound, beside an empty kernel's;
4. ntt kernels   the NTT forward, inverse, modular-product and fused
                 negacyclic-product kernels against their plain versions
                 on the card, bit for bit: N = 1024 at 1 to 24 and 4096
                 rows, each chain prime, the special prime and all four
                 (or the chain's three) stacked in one launch; every other
                 ring from 2 to 8192 at odd row counts; round trips;
                 negacyclic products against the O(N^2) product at N = 64;
                 the fused kernel's T-term sums (T = 1..4), every cipher
                 shape and runs longer than a run carries; misaligned
                 operands refused;
5. parity        a small planned two-party merge on the card equals the
                 same job run with device="cpu" (outputs, AND count, table
                 digest; the CPU run in a process of its own, started
                 before the build), and a sync-swap job;
6. ckks parity   rmvmul n=4 and rstats n=8 at rings 128 and 1024 on the
                 card equal their device="cpu" runs: decoded outputs and
                 the final engine memory, bit for bit;
7. main          the planned two-party merge at n=4096 records per party
                 (Fig. 8's 16384 cut to fit the time limit), checked
                 against the oracle, every AND gate through the kernels;
8. ckks main     rmvmul n=24 at ring 1024, levels 2, budget 0.4, 8
                 prefetch pages, checked against the oracle (atol 2e-2),
                 with the plan's 646/309 swaps and every transform and
                 product through the kernels, in the launches its
                 instruction mix gives (one fused launch an encryption,
                 decryption, tensor-product call and relinearization; the
                 standalone ones in key generation only); then rstats
                 n=128 at the same width;
9. baselines     (run after the serve phases) the paper's baselines
                 beside the main jobs: the GC main job unbounded (the
                 traced program over the whole virtual address space, no
                 swap directive; outputs equal to the main phase's, the
                 same AND count, every AND through the kernels), its
                 execute s against the planned run's and the frame bytes
                 of both; the CKKS main job planned and unbounded in
                 turns, three rounds; each eviction policy (min_clean,
                 lru, fifo, min with swap bypass, lru without prefetch)
                 at merge n=512 and the CKKS main job, swap counts equal
                 to the JAX package's plans; the scalar engine loop
                 against the batched one (and merge n=512 unbounded on
                 both) and the swap file against pinned pages on the same
                 jobs; card against CPU for unbounded and scalar CKKS
                 jobs at rings 128 and 1024 and an unbounded merge n=256
                 (the CPU runs in a process of their own, started at the
                 top);
                 both main jobs unbounded under torch.profiler (the busy
                 share);
10. gc workloads (after the baselines) the rest of the GC workloads and
                 the apps, two-party on the batched loop, each checked
                 against its oracle: ljoin n=128, mvmul n=192 and
                 binfclayer n=512 at budget 0.4 with 64 prefetch pages
                 (binfclayer also unbounded), sort n=16384 unbounded and
                 n=512 planned (8 prefetch pages), passreuse n=1024, pir
                 n=256 at ring 1024; every AND gate through the half-gates
                 kernels (8 to 128 gates a launch), pir's transforms and
                 products in the launches its instruction mix gives; each
                 GC job again through the plaintext oracle driver (the
                 sorts held bit for bit to the same runs on the CPU); card
                 against CPU at the port's test sizes (outputs, AND count,
                 table digest; the plaintext driver's outputs and final
                 engine memory; pir's outputs and memory), the CPU runs in
                 a process of their own meanwhile;
11. workers      multi-worker jobs and the overlap backend at Fig. 10's
                 four workers a party, each checked against its oracle
                 beside the one-worker job of the same n: two-party merge
                 n=1024 unbounded and planned at 0.4 with 16 prefetch
                 pages (batched), n=2048 unbounded on the batched and the
                 overlap loop; rsum n=256 and rmvmul n=24 at ring 1024
                 planned (lookahead 100, 16 prefetch pages) and unbounded
                 on both loops; NET messages and bytes per worker link,
                 posted and in-flight receives, swaps; every AND gate and
                 every transform and product through the kernels; card
                 against CPU for two-party merge n=64 at two workers (the
                 table stream of each party link) and rsum n=32 at four
                 (every engine's final memory) on both loops, the CPU
                 runs in a process of their own meanwhile;
12. fleet        saved plans and one process a rank, through the port's
                 CLI (``plan``, then ``fabric``: a ``run JOBDIR --worker
                 K`` process a rank over localhost TCP, each on the card
                 and checked, every AND gate and NTT of each rank through
                 the kernels): the parity phase's planned merge n=256 as a
                 garbler and an evaluator process (outputs, AND count and
                 the garbler's table digest equal to the in-process card
                 run); the unbounded merge n=4096 as two processes (the
                 party link's bytes over TCP), equal to the same job run
                 in this process; the unbounded merge n=1024
                 at four workers a party as eight processes and at one as
                 two, beside the workers phase's in-process runs of the
                 same jobs; rsum n=256 at four
                 workers, ring 1024, as four processes (NTT launches equal
                 to the in-process run's);
13. streaming    plans made out of core (``plan_mode="streaming"``) and
                 run from their memory-program files, each checked against
                 its oracle and held to its memory-mode run of this call:
                 the parity merge n=256 and the sync-swap job on the
                 batched loop (the file's records digest equals the
                 in-memory plan's; outputs, AND count, swaps and the
                 garbler's table digest equal the parity phase's card
                 runs); the CKKS main job from its file (646/309
                 swaps, outputs bit for bit and NTT launches equal to the
                 ckks main phase's); ljoin n=128 at budget 0.4 with 64
                 prefetch pages (ANDs and swaps equal to the gc workloads
                 phase's); GC main's plan made out of core equal to the
                 records the main phase ran (plan, annotate s, the
                 planner's tracemalloc peak); and Fig. 8's streaming case,
                 merge n=131072 written by the vectorized trace and
                 planned file to file in a process of its own started at
                 the top (its memory program above the reference's 8 MiB
                 planner cap, the planner's peak under half of it, its
                 records those of the DSL trace's in-memory plan);
14. shamir       the n-party Shamir jobs on the card (no kernel on this
                 path: the GF(2^61 - 1) field ops are PyTorch tensor ops):
                 shamir_stats n=2048 at 3 parties and n=2560 at 5
                 (fig_nparty's cases) and shamir_cmp n=1024 at 3, each
                 planned at budget 0.5 and run on the scalar, batched and
                 overlap loops, checked against its oracle; every loop's
                 outputs and NET messages and bytes per worker link equal;
                 every rank's final engine memory equal to the same jobs
                 run with device="cpu" (in a process of their own
                 meanwhile); fig_nparty's two sections: the
                 simulator's NET stall in order against overlap on the
                 planned program (11 ms one way, 250 MB/s a flow; model
                 seconds) and measure_traffic over shaped links with the
                 same fabric, scalar against overlap loop (identical
                 outputs and total bytes required, the speedup recorded);
15. bench        host work in a process of its own started after the
                 build:
                 run_bench over the ten Fig. 8 cases at budget 0.4 with
                 its MAGE-beats-OS check, the tiny streaming case (merge
                 4096 planned out of core), the array simulator cores
                 against the scalar ones field for field on merge 2048 and
                 rsum 128, and Session.simulate of GC main's spec, whose
                 simulated MAGE / unbounded is logged beside the baselines
                 phase's measured planned / unbounded execute time (the
                 simulator's seconds are outputs of its STORAGE
                 calibration, the same on every host);
16. serve daemon ``python -m repro_torch serve`` as a process of its own
                 on the card: serve_bench's plan-only cases (merge 4096,
                 sort 2048, rsum 128 at budget 0.4, streaming) five rounds
                 cold (no cache) and five hot, jobs/s both ways, hot plan
                 digests equal to cold, and the daemon's counters showing
                 no trace and no plan while hot; merge n=512 (two-party,
                 the half gates), rsum n=128 (ring 1024, the NTT kernels)
                 and aggsum n=512 (two-party) at 0.4 executed on its card
                 and checked, cold then hot (equal outputs digests and
                 kernel launches, plan and batch schedule from the cache;
                 the launches from the daemon's own counters, read just
                 before and after each run); an oversized job rejected
                 through ``python -m repro_torch submit`` (exit 3) and two
                 clients served at once;
17. aggregate    secure aggregation, the servers' share matrices and sums
                 on the card, every round checked bit for bit against
                 expected_sum: agg_bench's three rows at full size (2000
                 clients x 64 words x 3 rounds: fan-in under a 256 KiB
                 in-flight bound, each gateway link's reorder peak at or
                 under the knob plus its largest message; a shaped WAN of
                 2 ms and 200 MB/s with latency percentiles; the round-plan
                 cache cold then hot, no re-plan hot), a model-update round
                 (1000 clients x 65536 words: a 512 MiB share matrix a
                 server) and the 2000 x 64 round as four processes over
                 localhost TCP (``python -m repro_torch agg --rank K``; 2
                 servers, 2 gateways) equal to the in-process run
                 (aggregates, survivors, link bytes); the card's int64 sum
                 wraps as the uint64 sum on words near 2**64;
18. record       each kernel timed at each path's launch sizes, beside
                 its bound, its plain version and (the product) the
                 PyTorch expression, with the host's time per wrapper call
                 and the empty kernel; the NTT kernels also at 4096 rows,
                 with a host breakdown of a wrapper call; the fused kernel
                 over its launch shapes, beside the three standalone
                 launches each one replaces, timed at the same sizes;
19. profile      the GC path's shape at n=256 and the CKKS main job under
                 torch.profiler: device time by op, and the busy share;
20. attn kernels the paged-attention kernels (split and combine) against
                 their plain version on the card (rtol 1e-4, atol 1e-5),
                 f32 and bf16 pages: the JAX package's test shapes, qwen2's
                 head shape at batch 1 and 8 (ragged lengths, permuted
                 pages, -1 tails), batch 8 at lengths up to 32768 tokens in
                 bf16, the edge lengths 1, 63, 64, 65, 128, 129 and 32768
                 over host tables and over tables prepared with 2-page
                 chunks, stablelm-3b's heads (head_dim 80) and a group of
                 16;
21. serve parity reduced qwen2 in f32 with nonzero biases served on the
                 card equals the same run with device="cpu": greedy tokens,
                 and teacher-forced logits within relative 1e-4, for the
                 paged and the contiguous decode;
    families parity  every family of the serve families phase at its
                 reduced config in f32, card against CPU within relative
                 1e-4: prefill logits and caches, three contiguous decode
                 steps and (but int8) three paged ones through the kernel;
                 deepseek-moe-16b, phi3.5-moe, zamba2-7b, xlstm-1.3b,
                 chameleon-34b, seamless-m4t-medium as an ATTN stack,
                 qwen2 with the int8 KV cache, and the encoder-decoder's
                 prefill and serve_step_encdec;
22. serve main   qwen2-1.5b at full width in bf16 (seeded weights) through
                 run_server with the paged decode: 4 requests of 200-token
                 prompts, 64 new tokens each, every decode attention through
                 the kernels (252 steps x 28 layers wrapper calls, the
                 tables prepared once a step), held against the contiguous
                 decode teacher-forced on its tokens;
23. serve stablelm  stablelm-3b (head_dim 80) at full width, 1 request of
                 64 prompt tokens and 8 new ones, paged (7 steps x 32
                 layers wrapper calls) against its contiguous decode;
    serve families   each model at its published widths and depth, seeded
                 on the card and freed before the next: deepseek-moe-16b
                 (64 routed experts, dense dispatch) and zamba2-7b (81
                 Mamba2 layers, 13 applications of one shared attention
                 block of head_dim 112), 2 requests of 128 + 16 tokens
                 through run_server paged (28 and 13 calls a step), the
                 first request teacher-forced through the paged and the
                 contiguous decode in bf16 (greedy agreement, expert
                 routing flips) and in the model rebuilt in f32 (logits
                 within 1e-3), the bf16 residual stream against f32's
                 block by block; xlstm-1.3b the same, paged without a
                 paged call, tokens equal to the contiguous run's; seamless-m4t-medium's encoder-decoder
                 (256 frames, a 16-token prompt fed through
                 serve_step_encdec, its last logits within 3e-2 of
                 encdec_prefill's, 16 greedy steps); qwen2-1.5b with the
                 int8 KV cache beside bf16 (agreement, logits, KV bytes)
                 and with a prompt of 8192 tokens through _sdpa_chunked
                 (layer 0 held to the dense formula within 1e-4 in f32),
                 then 8 paged steps; ms a decode step, prefill tokens/s,
                 peak memory and paged calls of each;
    train parity  one train step (2 microbatches) of each family's
                 reduced config in f32 on the card and on the CPU from one
                 seeded state and one batch_for_step batch: qwen2-1.5b,
                 deepseek-moe-16b, zamba2-7b, xlstm-1.3b and
                 seamless-m4t-medium; loss, grad_norm, lr, mu and nu
                 within relative 1e-4 a leaf, the parameters too but for
                 entries whose gradient is at rounding noise (under 1e-4
                 of the largest RMS), held within 2 lr;
    train        qwen2-1.5b at its published widths in bf16, seeded on the
                 card: 8 steps of train_loop at the reference launcher's
                 defaults (batch 8 x seq 128, 2 microbatches, remat, no
                 checkpoint), every loss and grad_norm finite, the
                 parameters moved, the optimizer at step 8; ms a step,
                 tokens/s, peak memory against the 28.4 GB of state
                 reckoned, the share of the bf16 dense peak; one step
                 timed in halves (forward + backward, optimizer) and one
                 under torch.profiler; then the reduced qwen2 loop on the
                 card with checkpoints: 8 steps straight against 4 +
                 resume + 4 (rtol 1e-5, atol 1e-6) and a NaN at step 5 (one
                 rollback, final step 8);
    offload      fx_trace (fake mode) of the gradient of lm_loss for
                 full-width qwen2-1.5b at 4 x 128 without remat, its
                 contract checked; plan_offload unbounded and at half the
                 peak (both feasible); est_overhead at the pinned copy rate
                 measured here; the same gradient on the card, its
                 allocator peak beside peak_unbounded;
    distributed  (a) a world of one on the card (NCCL, a (1, 1) mesh):
                 reduced qwen2 in f32 sharded (DTensor parameters by
                 params_shardings, ZeRO optimizer state, grad_pspecs)
                 against unsharded, loss, gradients, mu and nu within
                 relative 1e-5 and parameters within 1e-5; qwen2-1.5b at
                 full width in bf16, 3 steps of the train phase's batch
                 both ways, losses and parameters within 1e-4 (noise
                 entries within 2 lr), ms a step both ways; (b) the
                 pipeline (reduced stablelm-3b at 4 layers, 2 stages, 2
                 microbatches) as two processes on the card over gloo,
                 activations and gradients through host memory, loss
                 and gradients within 1e-5 of lm_loss(aux_weight=0) and
                 autograd; (c) the dry run's cells, built in a process
                 started at the top (no card): qwen2-1.5b decode_32k on
                 pod256 (ok, per-rank bytes under 80 GB, memory-bound),
                 stablelm-3b decode_32k on pod512, qwen2-1.5b train_4k on
                 pod256 and the train phase's own cell on (1, 1), whose
                 analytic bound is printed beside (a)'s ms a step;
24. attn record  a wrapper call timed at the main path's lengths and at the
                 32768-token batch: device time summed over the kernels it
                 launches (split and combine also apart, profiler), the
                 host's time per call over prepared and over host tables
                 (events), beside the bound, the plain version and gather +
                 scaled_dot_product_attention; and at four lengths of each
                 serve families path, at its heads (``by_path``);
25. serve profile a few decode steps of the serve main job under
                 torch.profiler: device time by op and the busy share.

The last four lines are a JSON summary of the run's headline numbers, the
card's name and power limit, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api import (SLOT_BYTES, JobSpec, Session,  # noqa: E402
                             check_outputs, resolve_plan_config)
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.garble import kernel as gk, ops, ref  # noqa: E402
from repro_torch.kernels.ntt import kernel as nk  # noqa: E402
from repro_torch.kernels.ntt import ops as nops, ref as nref  # noqa: E402
from repro_torch.kernels.paged_attn import kernel as pk  # noqa: E402
from repro_torch.kernels.paged_attn import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attn import ref as pref  # noqa: E402
from repro_torch.launch.serve import paged_cache, run_server  # noqa: E402
from repro_torch.models import (encdec_init_caches,  # noqa: E402
                                encdec_prefill, encode, init_encdec, init_lm,
                                lm_decode, lm_prefill)
from repro_torch.models import layers as mlayers  # noqa: E402
from repro_torch.core.bytecode import (Op, ProgramFile,  # noqa: E402
                                       encode_chunk, iter_instructions)
from repro_torch.core.liveness import (file_digest,  # noqa: E402
                                       records_digest,
                                       working_set_pages_stream)
from repro_torch.core.planner import plan, plan_streaming  # noqa: E402
from repro_torch.core.engine import SWAP_DIRECTIVES  # noqa: E402
from repro_torch.core.simulator import simulate_memory_program  # noqa: E402
from repro_torch.core.transport import FabricSpec  # noqa: E402
from repro_torch.core.transport import aggregate_links  # noqa: E402
from repro_torch.protocols.ckks import cipher as ck  # noqa: E402
from repro_torch.protocols.ckks.driver import homomorphic_ops  # noqa: E402
from repro_torch.protocols.ckks.params import CkksParams  # noqa: E402
from repro_torch.scenarios import (BENCH_CASES, OS_PAGE_BYTES,  # noqa: E402
                                   STORAGE, TINY_STREAMING_CASE, cost_fn,
                                   measure_traffic, run_bench, scenario_spec)
from repro_torch.serve.serve_step import (Request, serve_step,  # noqa: E402
                                          serve_step_encdec)
from repro_torch.workloads import fast_trace  # noqa: E402
from repro_torch.workloads import get as get_workload  # noqa: E402
from repro_torch.core.offload import (fx_trace, loss_grad,  # noqa: E402
                                      plan_offload)
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault import FaultConfig  # noqa: E402
from repro_torch.train.optimizer import (OptConfig,  # noqa: E402
                                         adamw_update, init_opt_state)
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          accumulate_grads, make_train_state,
                                          train_step)
from repro_torch.distributed.pipeline import (  # noqa: E402
    pipeline_loss, split_stage_params, stage_param_specs)
from repro_torch.distributed.sharding import (  # noqa: E402
    P, NamedSharding, distribute, distribute_opt_state, distribute_params,
    params_shardings, rules_for, use_rules, zero_pspecs)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import named as named_shardings  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

#: H100 SXM peaks: HBM3 bandwidth (NVIDIA data sheet), and 32-bit
#: three-input logic operations (LOP3) per second: 64 per SM per clock (CUDA
#: C++ programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
LOP3_PER_S = 132 * 64 * 1.98e9
#: 32-bit integer operations per second: the same guide's table gives 64
#: results per SM per clock for 32-bit add/subtract, multiply and
#: multiply-add, shifts, compares and min/max at compute capability 9.0
INT_OPS_PER_S = 132 * 64 * 1.98e9

KERNEL_SIZES = (1, 8, 16, 32, 37, 64, 128, 4096, 1 << 20)
GIDS = (0, (1 << 31) + 5, 1 << 40)
#: the record phase times each half-gates kernel at this many of its paths'
#: launch sizes, those with the most launches
RECORD_SIZES = 12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)
    return smi


def phase_build() -> dict:
    """One nvcc per library, all started together; returns the half-gates
    kernels' registers (ptxas) and SASS instruction counts."""
    from concurrent.futures import ThreadPoolExecutor
    libs = (gk, nk, pk)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.library) for lib in libs]:
            f.result()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(libs)} "
        f"libraries in parallel")
    for lib in libs:
        info = lib.build_info()
        log(f"build: nvcc {info.seconds:.2f} s -> "
            f"{os.path.relpath(info.path, ROOT)}")
        if lib is nk:
            for name, c in ntt_code().items():
                log(f"  ptxas {name}: {c.get('registers')} registers, "
                    f"spill stores/loads {c.get('spill_stores')}/"
                    f"{c.get('spill_loads')} bytes, stack frame "
                    f"{c.get('stack')} bytes; sass {c.get('instructions')} "
                    f"instructions, BAR {c.get('BAR')}, LDG {c.get('LDG')} "
                    f"({c.get('LDG_before_BAR')} before the first BAR), STG "
                    f"{c.get('STG')}, STS {c.get('STS')}, LDS {c.get('LDS')}")
            continue
        for line in info.log.splitlines():
            if "Compiling entry" in line:
                log(f"  ptxas: {line.strip().split('function ')[-1]}")
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    out = gate_code()
    out["ntt_ptxas"] = ntt_code()
    out["attn_sass"] = attn_sass()
    for name, c in out["attn_sass"].items():
        log(f"  sass {name}: " + ", ".join(f"{op} {n}" for op, n in
                                          c.items()))
    for name, c in out["sass"].items():
        log(f"  sass {name}: {c['instructions']} instructions "
            f"({c['per_thread']} per thread), LOP3 {c['LOP3']}, SHF "
            f"{c['SHF']}, SHFL {c['SHFL']}, indexed LDC {c['LDC_indexed']}, "
            f"branches {c['branches']}, loops {c['loops']}, registers "
            f"{out['registers'].get(name)}")
    return out


@functools.cache
def gate_code() -> dict:
    """The half-gates kernels' registers (ptxas, when this process built
    the library) and SASS counts, read once."""
    info = gk.build_info()
    return {"registers": ptxas_registers(info.log),
            "sass": sass_counts(info.path)}


#: an NTT kernel instantiation in a mangled name: ntt_fwd_kernel<10> is the
#: forward at N = 1024
_NTT_ENTRY = re.compile(r"(ntt_fwd_kernel|ntt_inv_kernel|mul_mod_kernel|"
                        r"ntt_mul_kernel)(?:I((?:Li\d+E)+)E)?")


def _ntt_name(mangled: str) -> str | None:
    m = _NTT_ENTRY.search(mangled)
    if not m:
        return None
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


@functools.cache
def ntt_code() -> dict:
    """Registers, spill bytes and stack frame of every NTT kernel
    instantiation (ptxas -v in the build's log) and its SASS counts of
    instructions, barriers, global loads (before the first barrier too),
    global stores and shared-memory stores and loads, by name."""
    out, name = {}, None
    for line in nk.build_info().log.splitlines():
        if "Compiling entry" in line:
            name = _ntt_name(line)
            if name:
                out[name] = {}
        elif name and "stack frame" in line:
            stack, stores, loads = (int(x) for x in
                                    re.findall(r"(\d+) bytes", line)[:3])
            out[name].update(stack=stack, spill_stores=stores,
                             spill_loads=loads)
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    for mangled, c in sass_counts(nk.build_info().path).items():
        name = _ntt_name(mangled)
        if name in out:
            out[name].update(
                instructions=c["instructions"], BAR=c["BAR"],
                LDG=c["ops"].get("LDG", 0),
                LDG_before_BAR=c["LDG_before_BAR"],
                STG=c["ops"].get("STG", 0), STS=c["ops"].get("STS", 0),
                LDS=c["ops"].get("LDS", 0))
    return out


def _clocks() -> str:
    """The card's SM clock, its maximum, temperature and power draw now:
    a launch of a few µs runs at whatever clock the card is at."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _log_gate_code() -> None:
    code = gate_code()
    for name in ("garble_and_kernel", "eval_and_kernel"):
        c = code["sass"].get(name, {})
        log(f"  {name}: {c.get('per_thread')} SASS instructions per thread "
            f"(each thread one AES pass), {code['registers'].get(name)} "
            f"registers")


def _kernel_name(mangled: str) -> str:
    """garble_and_kernel from its mangled name."""
    for name in ("garble_and_kernel", "eval_and_kernel", "empty_kernel"):
        if name in mangled:
            return name
    return mangled


def ptxas_registers(build_log: str) -> dict:
    """Registers per kernel from ``ptxas -v``'s lines."""
    regs, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            name = _kernel_name(line)
        elif "Used" in line and "registers" in line and name:
            regs[name] = int(line.split("Used")[1].split()[0])
    return regs


def sass_counts(lib_path) -> dict:
    """SASS instructions of each kernel in a built library, from
    ``cuobjdump -sass``: the count (the padding NOPs and the closing branch
    to itself left out), LOP3 and SHF (the logic and the rotations),
    shuffles, constant loads with a register index (a table or round key
    read by index would show here), branches, and the loops, as
    [instructions in the body] per backward branch, ``ops``, the count of
    each opcode, and the barriers (BAR) with the global loads before the
    first of them.  ``per_thread`` is the most one thread can issue (the
    count) where the kernel has no loop, else None.  Empty where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("  sass: no cuobjdump in this toolkit: not measured")
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    line_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*([^;]*);")
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = {"instructions": 0, "LOP3": 0, "SHF": 0, "SHFL": 0,
                   "LDC_indexed": 0, "branches": 0, "loops": [], "ops": {},
                   "LDG_before_BAR": 0, "BAR": 0}
            out[_kernel_name(line.split("Function :")[1].strip())] = cur
            continue
        mt = line_re.search(line)
        if cur is None or not mt:
            continue
        addr, op, args = int(mt.group(1), 16), mt.group(2), mt.group(4)
        if op == "NOP":
            continue
        cur["ops"][op] = cur["ops"].get(op, 0) + 1
        if op == "BRA":
            target = re.search(r"0x([0-9a-f]+)", args)
            if target and int(target.group(1), 16) == addr:
                continue                       # the closing self-loop
            cur["branches"] += 1
            if target and int(target.group(1), 16) < addr:
                cur["loops"].append((addr - int(target.group(1), 16)) // 16
                                    + 1)
        cur["instructions"] += 1
        if op in ("LOP3", "SHF", "SHFL", "BAR"):
            cur[op] += 1
        if op == "LDG" and not cur["BAR"]:
            cur["LDG_before_BAR"] += 1
        if op in ("LDC", "ULDC") and re.search(
                r"c\[0x[0-9a-f]+\]\[U?R\d", args):
            cur["LDC_indexed"] += 1
    for c in out.values():
        c["per_thread"] = None if c["loops"] else c["instructions"]
    return out


#: SASS opcodes that show the paged-attention kernels' design: tensor-core
#: products (HMMA), shared-memory matrix loads (LDSM), cp.async (LDGSTS),
#: register transposes (MOVM), shuffles and special-function ops (MUFU)
ATTN_SASS_OPS = ("HMMA", "LDSM", "LDGSTS", "MOVM", "SHFL", "MUFU", "FFMA")


def attn_sass() -> dict:
    """Per paged-attention kernel instantiation (demangled where c++filt
    is there), the static count of each ATTN_SASS_OPS opcode."""
    out = {}
    for name, c in sass_counts(pk.build_info().path).items():
        if shutil.which("c++filt"):
            name = subprocess.run(["c++filt", name], capture_output=True,
                                  text=True).stdout.strip()
        name = name.replace("(anonymous namespace)::", "")
        out[name.split("(")[0].replace("void ", "")] = {
            op: c["ops"].get(op, 0) for op in ATTN_SASS_OPS}
    return out


def _labels(rng: np.random.Generator, m: int, dev) -> torch.Tensor:
    x = rng.integers(0, 1 << 64, (m, 2), dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(dev)


def _max_abs_err(outs, plains) -> int:
    """Largest |kernel - plain| over the compared 64-bit words, each read
    as unsigned (the labels' and tables' bit views)."""
    err = 0
    for k, p in zip(outs, plains):
        a = k.cpu().numpy().view(np.uint64)
        b = p.cpu().numpy().view(np.uint64)
        if a.size:
            err = max(err, int(np.max(np.where(a > b, a - b, b - a))))
    return err


def _device_ms(fn, reps: int) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls (five rounds, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        rounds.append(start.elapsed_time(stop) / reps)
    return statistics.median(rounds)


def _kernel_ms(fn, name: str, reps: int) -> float | None:
    """Mean duration of the kernel ``name`` on the device over ``reps``
    calls, from the profiler's CUDA trace; None if three traces in a row
    show none (a trace can come back without the kernel's records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        tot = cnt = 0
        for ev in prof.key_averages():
            if name in ev.key:
                tot += getattr(ev, "device_time_total", 0) or \
                    getattr(ev, "cuda_time_total", 0)
                cnt += ev.count
        if cnt and tot:
            return tot / cnt / 1e3
    log(f"  (the profiler showed no {name}; timing it with CUDA events)")
    return None


def _call_kernels_ms(fn, match: str, reps: int) -> dict | None:
    """Device time per call of every kernel a call launches whose name
    holds ``match``, by kernel name, from the profiler's CUDA trace (mean
    over ``reps`` calls); None if three traces in a row show none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if match in ev.key:
                name = _attn_kernel_name(ev.key)
                out[name] = out.get(name, 0.0) + _dev_us(ev) / reps / 1e3
        if out and all(out.values()):
            return out
    log(f"  (the profiler showed no {match} kernel; timing the call with "
        f"CUDA events)")
    return None


def phase_kernels(dev) -> tuple[dict, dict, dict]:
    """Kernels against their plain versions, bit for bit, then each one's
    device and host time at the main path's launch sizes, at 64 and at 2^20
    gates, beside an empty kernel's.  Returns each kernel's max_abs_err over
    the comparisons, its ms at 2^20, and the timings."""
    rng = np.random.default_rng(2024)
    checked = 0
    errs = {"garble_and": 0, "eval_and": 0}
    big = {}
    for m in KERNEL_SIZES:
        a, b = _labels(rng, m, dev), _labels(rng, m, dev)
        r = rng.integers(0, 1 << 64, 2, dtype=np.uint64)
        r[0] |= np.uint64(1)
        rt = torch.from_numpy(r.view(np.int64).copy()).to(dev)
        for gid0 in GIDS:
            c, tab = ops.garble_and(a, b, ops.offset(r), gid0)
            err = _max_abs_err((c, tab), ref.garble_and(a, b, rt, gid0))
            errs["garble_and"] = max(errs["garble_and"], err)
            if err:
                raise AssertionError(f"garble_and != plain at m={m} "
                                     f"gid0={gid0}: max_abs_err {err}")
            for bit_a in (0, 1):
                for bit_b in (0, 1):
                    wa = a ^ (rt * bit_a)
                    wb = b ^ (rt * bit_b)
                    w = ops.eval_and(wa, wb, tab, gid0)
                    err = _max_abs_err((w,), (ref.eval_and(wa, wb, tab,
                                                           gid0),))
                    errs["eval_and"] = max(errs["eval_and"], err)
                    if err:
                        raise AssertionError(f"eval_and != plain at m={m} "
                                             f"gid0={gid0}: max_abs_err "
                                             f"{err}")
                    if not torch.equal(w, c ^ (rt * (bit_a & bit_b))):
                        raise AssertionError(
                            f"truth table row ({bit_a},{bit_b}) fails at "
                            f"m={m} gid0={gid0}")
            checked += 1
    torch.cuda.synchronize()
    log(f"kernels: garble_and and eval_and equal their plain versions bit "
        f"for bit (tolerance 0: integer crypto) at m in {KERNEL_SIZES} x "
        f"gid0 in {GIDS}, all four truth-table rows ({checked} cases)")

    _log_gate_code()
    timing = {"empty": _empty_launch(dev, 500), "clocks": _clocks()}
    log(f"  clocks (sm, max sm, temperature, power): {timing['clocks']}")
    log(f"  empty kernel (the launch floor): {timing['empty']['ms']} ms "
        f"(profiler), {timing['empty']['host_ms']:.4f} ms per call (events)")
    for m in (16, 32, 64, 1 << 20):
        a, b = _labels(rng, m, dev), _labels(rng, m, dev)
        r = ops.offset(rng.integers(0, 1 << 64, 2, dtype=np.uint64))
        _, tab = ops.garble_and(a, b, r, 7)
        reps = 20 if m > 4096 else 500
        for name in ("garble_and", "eval_and"):
            one = _gate_timing(name, a, b, r, tab, reps)
            timing.setdefault(name, {})[m] = one
            ms = one["ms"]
            log(f"  {name} m={m}: kernel {one['kernel_ms']} ms (profiler), "
                f"{one['host_ms']:.4f} ms per call (events), bound "
                f"{one['bound_ms']:.3e} ms ({one['bound_ms'] / ms:.3g} of "
                f"it), plain {one['plain_ms']:.4f} ms, "
                f"{m / ms * 1e3:.3e} ANDs/s")
            if m == 1 << 20:
                big[name] = {"ms": ms, "bound_ms": one["bound_ms"],
                             "plain_ms": one["plain_ms"]}
    timing["wrapper_us"] = _wrapper_costs(dev)
    log("  host µs per piece of a 16-gate wrapper call (host clock, back "
        "to back): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                 timing["wrapper_us"].items()))
    return errs, big, timing


def _wrapper_costs(dev, reps: int = 2000) -> dict:
    """Host µs of the pieces of a 16-gate wrapper call, each timed on the
    host's clock over back-to-back calls (median of five rounds taken in
    turns): the outputs' allocation and views, the checks of one label
    tensor, the ctypes call alone (m = 0 launches nothing), a launch of the
    empty kernel, and the whole garble_and and eval_and."""
    m = 16
    rng = np.random.default_rng(16)
    a, b = _labels(rng, m, dev), _labels(rng, m, dev)
    _, tab = ops.garble_and(a, b, (3, 5), 0)
    pa = a.data_ptr()
    pieces = {
        "outputs": lambda: ops._garble_outputs(m, a),
        "check": lambda: ops._check(a, "a", 2, m, dev),
        "ctypes": lambda: gk._garble(pa, pa, 3, 5, 0, pa, pa, 0, 0),
        "empty_launch": lambda: gk.launch_empty(dev),
        "garble_and": lambda: ops.garble_and(a, b, (3, 5), 0),
        "eval_and": lambda: ops.eval_and(a, b, tab, 0),
    }
    return _host_us(pieces, reps)


def _host_us(pieces: dict, reps: int) -> dict:
    """Host µs per call of each piece, on the host's clock over ``reps``
    back-to-back calls, the median of five rounds taken in turns."""
    rounds = {k: [] for k in pieces}
    for _ in range(5):
        for name, fn in pieces.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            rounds[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in rounds.items()}


def _empty_launch(dev, reps: int) -> dict:
    """The empty kernel's device time (profiler) and the host's time per
    back-to-back launch of it (events): the floor under a launch."""
    fn = lambda: gk.launch_empty(dev)  # noqa: E731
    return {"ms": _kernel_ms(fn, "empty_kernel", reps),
            "host_ms": _device_ms(fn, reps)}


def _gate_timing(name: str, a, b, r, tab, reps: int) -> dict:
    """One half-gates kernel at one launch size: device ms per launch
    (profiler, the median of three traces), ms per back-to-back wrapper
    call (events: the host's pace where it is slower than the device), the
    plain version, the bound."""
    m = a.shape[0]
    rt = torch.tensor(np.array(r, np.uint64).view(np.int64), device=a.device)
    if name == "garble_and":
        kfn = lambda: ops.garble_and(a, b, r, 7)  # noqa: E731
        pfn = lambda: ref.garble_and(a, b, rt, 7)  # noqa: E731
        lop3, nbytes = gk.GARBLE_LOP3_PER_AND, gk.GARBLE_BYTES_PER_AND
    else:
        kfn = lambda: ops.eval_and(a, b, tab, 7)  # noqa: E731
        pfn = lambda: ref.eval_and(a, b, tab, 7)  # noqa: E731
        lop3, nbytes = gk.EVAL_LOP3_PER_AND, gk.EVAL_BYTES_PER_AND
    host_ms = _device_ms(kfn, reps)
    # a launch lasts a few µs, so one trace of a few hundred moves with the
    # card's clocks: the median of three
    traces = [_kernel_ms(kfn, f"{name}_kernel", reps) for _ in range(3)]
    kernel_ms = statistics.median(traces) if None not in traces else None
    ops_ms = m * lop3 / LOP3_PER_S * 1e3
    bytes_ms = m * nbytes / HBM_BYTES_PER_S * 1e3
    return {"kernel_ms": kernel_ms, "ms": kernel_ms or host_ms,
            "host_ms": host_ms, "plain_ms": _device_ms(pfn, max(reps // 50,
                                                                2)),
            "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms}


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

#: the main path: the JAX package's Fig. 8 merge case
#: (benchmarks/fig8_swap.py), its n = 16384 cut to 8192 and then to 4096
#: so that the whole script stays well inside its time limit on a slow
#: host (the main phase took 235 s at 16384 and 127 s at 8192: its swap
#: directives stop batching, so it runs at the host's pace per AND call;
#: the second cut made room for the serve families phase)
MAIN = dict(n=4096, memory_budget=0.4, lookahead=10_000, prefetch_pages=64)
#: small enough to run on the CPU too, with a budget that forces swaps
PARITY = dict(n=256, memory_budget=0.4, lookahead=10_000, prefetch_pages=8)
#: no prefetch buffer: the plan keeps synchronous SWAP_IN / SWAP_OUT
SYNC_SWAPS = dict(PARITY, memory_budget=12, prefetch_pages=0)
#: the main path's shape at a thirty-second of its size, run under the
#: profiler (whose trace processing grows with the launches: 42 s at
#: n = 512): 14 frames of which 3 prefetch, 41 swaps each way
PROFILED = dict(n=256, memory_budget=14, lookahead=10_000, prefetch_pages=3)


def _run(job: dict, device, digest: bool = False):
    s = Session(JobSpec("merge", **job), device=device)
    t0 = time.perf_counter()
    out = s.execute(real=True, check=True, digest=digest)
    return s, out, time.perf_counter() - t0


def _swaps(s) -> tuple[int, int, int, int]:
    st = s.engine_stats
    return (sum(e.swap_ins for e in st), sum(e.swap_outs for e in st),
            sum(e.io_read_bytes for e in st),
            sum(e.io_write_bytes for e in st))


def program_digest(prog) -> int:
    """``records_digest`` of a program's records, in memory or in a file:
    equal iff the records are (chunk-size independent)."""
    if isinstance(prog, ProgramFile):
        return file_digest(prog)
    d = 0
    for i in range(0, len(prog.instrs), 8192):
        d = records_digest(d, encode_chunk(prog.instrs[i:i + 8192]), i)
    return d


def parity_cpu() -> dict:
    """The parity job with device="cpu": what the card's run is held to.
    ``main`` runs it in a process of its own (one thread) while the card
    builds and checks the kernels."""
    torch.set_num_threads(1)
    s, out, t = _run(PARITY, "cpu", digest=True)
    return {"outputs": out, "ands": [g.ands for g in s.gate_counts],
            "digest": s.table_digest, "s": t}


def phase_parity(dev, cpu: dict) -> dict:
    gpu, out_g, t_g = _run(PARITY, dev, digest=True)
    t_c = cpu["s"]
    if _swaps(gpu)[0] == 0:
        raise AssertionError("parity job did not swap")
    if not _same(out_g, cpu["outputs"]):
        raise AssertionError("card and CPU outputs differ")
    ands = [g.ands for g in gpu.gate_counts]
    if ands != cpu["ands"] or ands[0] != ands[1]:
        raise AssertionError(f"AND counts differ: {ands} vs {cpu['ands']}")
    if gpu.table_digest != cpu["digest"]:
        raise AssertionError("garbled-table streams differ")
    log(f"parity: merge n={PARITY['n']} on the card ({t_g:.2f} s) == on the "
        f"CPU ({t_c:.2f} s): {len(out_g)} outputs, {ands[0]} ANDs, table "
        f"sha256 {gpu.table_digest[:16]}, swaps in/out "
        f"{_swaps(gpu)[:2]}")
    sync, sync_out, t_s = _run(SYNC_SWAPS, dev)
    if _swaps(sync)[0] == 0 or sync.plan_reports[0].schedule.prefetched:
        raise AssertionError("the synchronous-swap job made no sync swaps")
    log(f"sync swaps: merge n={SYNC_SWAPS['n']} with SWAP_IN/SWAP_OUT only, "
        f"on the card ({t_s:.2f} s), checked against the oracle; swaps "
        f"in/out {_swaps(sync)[:2]}")
    # the card's runs, which the fleet phase's saved-plan job and the
    # streaming phase's streamed plans are held to
    ref = {"outputs": out_g, "ands": ands, "digest": gpu.table_digest,
           "swaps": list(_swaps(gpu)[:2]),
           "plan_digest": program_digest(gpu.plan()[0]),
           "sync": {"outputs": sync_out,
                    "ands": [g.ands for g in sync.gate_counts],
                    "swaps": list(_swaps(sync)[:2]),
                    "plan_digest": program_digest(sync.plan()[0])}}
    return {"card_s": t_g, "cpu_s": t_c, "sync_card_s": t_s}, ref


def phase_main(dev) -> tuple[dict, dict, dict]:
    """The main path; returns the kernels' counts from its run, its
    end-to-end metrics and its outputs."""
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    s, out, seconds = _run(MAIN, dev)
    counts = ops.counts()
    ins, outs, rbytes, wbytes = _swaps(s)
    if ins == 0 or outs == 0:
        raise AssertionError("main path did not swap")
    g_ands, e_ands = (g.ands for g in s.gate_counts)
    if counts["garble_ands"] != g_ands or counts["eval_ands"] != e_ands:
        raise AssertionError(f"ANDs through the kernels {counts} != gate "
                             f"counts {g_ands}, {e_ands}")
    t = s.timings
    table_bytes = sum(v.bytes for k, v in s.transport_stats.items()
                      if k[2] == 1)
    log(f"main: merge n={MAIN['n']} per party, budget {MAIN['memory_budget']}"
        f" of the working set ({s.config.num_frames} frames, "
        f"{s.config.prefetch_pages} prefetch), {len(out)} output chunks "
        f"checked against the oracle")
    log(f"  seconds: trace {t['trace_s']:.3f}, plan {t['plan_s']:.3f}, "
        f"batch schedule {t['batch_schedule_s']:.3f}, execute "
        f"{t['execute_s']:.3f} (all {seconds:.3f})")
    log(f"  AND gates {g_ands} per party, {g_ands / t['execute_s']:.4e} "
        f"AND gates/s end to end; table bytes {table_bytes}")
    log(f"  swaps: {ins} in / {outs} out, {rbytes} / {wbytes} bytes "
        f"(both parties)")
    log(f"  frame memory {s.engine_stats[0].frame_bytes} bytes per party, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"  launches: garble_and {counts['garble_launches']}, eval_and "
        f"{counts['eval_launches']}; sizes "
        f"{sorted(counts['launch_sizes']['garble'].items())[:8]}")
    metrics = {"n": MAIN["n"], **t, "ands": g_ands,
               "ands_per_s": g_ands / t["execute_s"],
               "table_bytes": table_bytes, "swaps": [ins, outs],
               "swap_bytes": [rbytes, wbytes],
               "frame_bytes": s.engine_stats[0].frame_bytes,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "plan_digest": program_digest(s.plan()[0])}
    return counts, metrics, out


def _dev_us(ev) -> float:
    return getattr(ev, "self_device_time_total", None) or \
        getattr(ev, "self_cuda_time_total", 0)


def phase_profile(dev) -> dict:
    """Where the device's time goes on the main path's shape: the device
    time of every CUDA op (kernels and copies) under torch.profiler, and
    their sum against the wall time of the execute stage.  The profiler
    slows the host, so the busy share is a lower bound on the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile
    s = Session(JobSpec("merge", **PROFILED), device=dev)
    s.plan()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.execute(real=True, check=True)
    wall_ms = s.timings["execute_s"] * 1e3
    evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in evs) / 1e3
    log(f"profile: merge n={PROFILED['n']}, execute {wall_ms:.1f} ms under "
        f"the profiler, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.3f} of it; idle share "
        f"{1 - busy_ms / wall_ms:.3f})")
    for e in evs[:8]:
        log(f"  {_dev_us(e) / 1e3:10.2f} ms  {e.count:8d}x  {e.key[:70]}")
    return {"n": PROFILED["n"], "execute_ms": wall_ms, "busy_ms": busy_ms}


def kernel_record(dev, paths: dict, errs: dict) -> tuple[list[dict], dict]:
    """Time each kernel at the launch sizes of each GC path's run (the
    ``RECORD_SIZES`` with the most launches) and report launch-weighted
    means beside the bound, the plain version, the host's time per wrapper
    call and an empty kernel's device time.  ``paths`` holds each path's
    counters, the GC main path first: a row carries the main path's
    launches and means, as the rows of earlier runs do, and ``by_path``
    each path's own.  ``errs`` holds the kernels phase's max_abs_err,
    which the comparisons here extend.  Returns the kernels' rows and the
    host and floor figures."""
    rng = np.random.default_rng(7)
    rows, extra = [], {"empty": _empty_launch(dev, 200), "clocks": _clocks()}
    log(f"  clocks (sm, max sm, temperature, power): {extra['clocks']}")
    spec = {"garble_and": ("garble", 151), "eval_and": ("eval", 175)}
    for name, (kind, line) in spec.items():
        timed = {}              # launch size -> its timing, checked once

        def at(m: int) -> dict:
            if m in timed:
                return timed[m]
            a, b = _labels(rng, m, dev), _labels(rng, m, dev)
            r = ops.offset(rng.integers(0, 1 << 64, 2, dtype=np.uint64))
            rt = torch.tensor(np.array(r, np.uint64).view(np.int64),
                              device=dev)
            _, tab = ref.garble_and(a, b, rt, 3)
            if kind == "garble":
                err = _max_abs_err(ops.garble_and(a, b, r, 7),
                                   ref.garble_and(a, b, rt, 7))
            else:
                err = _max_abs_err((ops.eval_and(a, b, tab, 7),),
                                   (ref.eval_and(a, b, tab, 7),))
            errs[name] = max(errs[name], err)
            if err:
                raise AssertionError(f"{name} != plain at m={m}: "
                                     f"max_abs_err {err}")
            timed[m] = _gate_timing(name, a, b, r, tab, 200)
            return timed[m]

        by_path = {}
        for path, counts in paths.items():
            every = counts["launch_sizes"][kind]
            # the sizes that carry the most launches (an unbounded job's
            # batches come in many sizes of a few launches each)
            sizes = dict(sorted(every.items(), key=lambda kv: -kv[1])
                         [:RECORD_SIZES])
            total = sum(sizes.values())
            acc = dict.fromkeys(("ms", "host_ms", "plain_ms", "ops_ms",
                                 "bytes_ms"), 0.0)
            for m, k in sizes.items():
                one = at(m)
                for key in acc:
                    acc[key] += k / total * one[key]
            bound = max(acc["ops_ms"], acc["bytes_ms"])
            by_path[path] = {
                "launches": counts[f"{kind}_launches"], "ms": acc["ms"],
                "plain_ms": acc["plain_ms"], "bound_ms": bound,
                "bound_by": "operations" if acc["ops_ms"] >= acc["bytes_ms"]
                else "bytes", "host_ms": acc["host_ms"],
                "weighted_share": total / sum(every.values())}
            log(f"  {name} over the {path} path's {len(sizes)} most launched "
                f"sizes of {len(every)} ({total / sum(every.values()):.6f} "
                f"of its {counts[f'{kind}_launches']} launches) "
                f"{dict(sorted(sizes.items()))}: {acc['ms']:.6f} ms per "
                f"launch (bound {bound:.3e} ms, plain {acc['plain_ms']:.4f} "
                f"ms), {acc['host_ms']:.5f} ms per wrapper call (events)")
        main = next(iter(by_path.values()))
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/garble/csrc/garble.cu",
            "replaces": f"src/repro/kernels/garble/kernel.py:{line}",
            "launches": main["launches"],
            "max_abs_err": float(errs[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "by_path": {p: {k: v[k] for k in ("launches", "ms", "plain_ms",
                                              "bound_ms")}
                        for p, v in by_path.items()}})
        extra[name] = {"ms": main["ms"], "host_ms": main["host_ms"],
                       "by_path": by_path}
    log(f"  empty kernel: {extra['empty']['ms']} ms (profiler), "
        f"{extra['empty']['host_ms']:.5f} ms per call (events)")
    _log_gate_code()
    return rows, extra


# ---------------------------------------------------------------------------
# the CKKS path: NTT kernels, parity, main job, record, profile
# ---------------------------------------------------------------------------

#: the repo's benchmark width (the JAX package's BENCH_CKKS): chain primes
#: q0, q1, q2 below 2^30 and the special prime P = 1073750017 above it
BENCH_CKKS = CkksParams(n_ring=1024, levels=2)
#: the CKKS main path: the JAX package's Fig. 8 CKKS case
#: (benchmarks/fig8_swap.py, scenarios.py BENCH_CKKS)
CKKS_MAIN = dict(workload="rmvmul", n=24, memory_budget=0.4,
                 lookahead=10_000, prefetch_pages=8, ckks_ring=1024,
                 ckks_levels=2)
CKKS_MAIN_SWAPS = (646, 309)
#: CT_MUL, CT_MUL_PLAIN and subtraction at the same width
CKKS_STATS = dict(CKKS_MAIN, workload="rstats", n=128)
#: (workload, n, ring, frames, prefetch): small enough for the CPU, and
#: every budget swaps
CKKS_PARITY = [("rmvmul", 4, 128, 3, 1), ("rstats", 8, 128, 4, 1),
               ("rmvmul", 4, 1024, 4, 1), ("rstats", 8, 1024, 4, 1)]
#: rings checked beside 1024: every one the kernels take (2 .. MAX_N)
NTT_RINGS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 2048, 4096, 8192)
NTT_KERNELS = {   # name -> (profiler name, the TPU kernel it replaces)
    "ntt_forward": ("ntt_fwd_kernel", "src/repro/kernels/ntt/kernel.py:67"),
    "ntt_inverse": ("ntt_inv_kernel", "src/repro/kernels/ntt/kernel.py:86"),
    "mul_mod": ("mul_mod_kernel", "src/repro/kernels/ntt/kernel.py:108"),
    # the composite of the three (ops.negacyclic_mul), in one launch
    "ntt_mul": ("ntt_mul_kernel", "src/repro/kernels/ntt/ops.py:49"),
}
#: the three standalone kernels a fused launch replaces
UNFUSED = ("ntt_forward", "mul_mod", "ntt_inverse")


def _residues(rng: np.random.Generator, primes, shape, dev) -> torch.Tensor:
    """Residues of shape (*shape, P, N) (P = len(primes) > 1) or shape,
    each row below its prime."""
    q = np.asarray(primes, dtype=np.int64)
    if len(primes) > 1:
        q = q[:, None]
    x = rng.integers(0, 1 << 62, shape, dtype=np.int64) % q
    return torch.from_numpy(x).to(dev)


def _ntt_plain(kind: str, a: torch.Tensor, b, primes) -> torch.Tensor:
    """The plain version on the card's tensors, with the wrapper's own
    device tables (ntt_mul: the product of a and b, a row each)."""
    if kind == "ntt_mul":
        return _mul_plain([a, b], [], ck.ONE_TERM, primes)
    n = a.shape[-1]
    ps = tuple(primes) if isinstance(primes, (list, tuple)) else (primes,)
    t = nops.tables(ps, n, a.device)
    v = a.reshape(-1, len(ps), n)
    if kind == "ntt_forward":
        out = nref.ntt_forward(v, t.q, t.psi)
    elif kind == "ntt_inverse":
        out = nref.ntt_inverse(v, t.q, t.psi_inv, t.n_inv)
    else:
        out = nref.mul_mod(v, b.reshape(-1, len(ps), n), t.q)
    return out.reshape(a.shape)


def _ntt_kernel(kind: str, a, b, primes) -> torch.Tensor:
    if kind == "mul_mod":
        return nops.mul_mod(a, b, primes)
    if kind == "ntt_mul":
        return nops.ntt_mul([a, b], [], ck.ONE_TERM, primes)
    return getattr(nops, kind)(a, primes)


def _mul_plain(coef, ntt, terms, primes) -> torch.Tensor:
    """ntt_mul's plain version (ref.ntt_mul: forward, products, sums,
    inverse) on the card's tensors, shaped as the wrapper's output; the
    operands as the wrapper takes them (stacks, or sequences)."""
    k = 1 if isinstance(primes, int) else 2

    def rows(x):
        if x is None:
            return []
        return list(x.unbind(-k - 1)) if isinstance(x, torch.Tensor) \
            else list(x)
    cs, ns = rows(coef), rows(ntt)
    ops_ = cs + ns
    ps = (primes,) if k == 1 else tuple(primes)
    tail = tuple(ops_[0].shape[-k:])
    t = nops.tables(ps, tail[-1], ops_[0].device)
    lead = tuple(torch.broadcast_shapes(*(x.shape[:-k] for x in ops_)))
    xs = [x.expand(*lead, *tail).reshape(-1, len(ps), tail[-1])
          for x in ops_]
    out = nref.ntt_mul(xs, len(cs), terms, t.q, t.psi, t.psi_inv, t.n_inv)
    return out.reshape(*lead, len(terms), *tail)


def _mul_check(coef, ntt, terms, primes, what: str) -> int:
    """The fused kernel against its plain version on one job, bit for bit;
    returns the max_abs_err (0)."""
    try:
        got = nops.ntt_mul(coef, ntt, terms, primes)
    except RuntimeError as e:
        raise RuntimeError(f"ntt_mul ({what}): {e}") from e
    err = _max_abs_err((got,), (_mul_plain(coef, ntt, terms, primes),))
    if err:
        raise AssertionError(f"ntt_mul != plain ({what}): max_abs_err {err}")
    return err


def _cipher_jobs(rng, dev) -> list:
    """The fused launches of the five cipher ops at the benchmark width, as
    cipher.py makes them: operand stacks, views of the secret's rows and of
    the keys: (what, coef, ntt, terms, primes)."""
    p = BENCH_CKKS
    chain = p.primes + [p.special_prime]
    jobs = []
    spow = _residues(rng, chain, (2, len(chain), p.n_ring), dev)
    for lvl in (2, 1):
        primes = tuple(p.level_primes(lvl))
        P = len(primes)
        basis = primes + (p.special_prime,)
        ae = _residues(rng, primes, (2, P, p.n_ring), dev)
        jobs.append((f"encrypt/decrypt P={P}", ae[:1], spow[:1, :P],
                     ck.ONE_TERM, primes))
        c = _residues(rng, primes, (2, P, p.n_ring), dev)
        jobs.append((f"decrypt of 3 components P={P}", c, spow[:2, :P],
                     ck.sum_terms(2), primes))
        for lead in ((), (5,), (24,)):
            x = _residues(rng, primes, (*lead, 4, P, p.n_ring), dev)
            jobs.append((f"mul_tensor {lead} P={P}", x, None,
                         ck.TENSOR_TERMS, primes))
        d = len(primes)
        dj = _residues(rng, basis, (d, len(basis), p.n_ring), dev)
        keys = _residues(rng, basis, (2, d, len(basis), p.n_ring), dev)
        jobs.append((f"relinearize D={d}", dj, keys.flatten(0, 1),
                     ck.sum_terms(d, 2), basis))
        x = _residues(rng, primes, (3, P, p.n_ring), dev)
        jobs.append((f"mul_plain P={P}", x, None, ck.plain_terms(2),
                     primes))
    # relinearize's largest part of the digits at a deeper level: 5
    # digits, 15 operands
    basis = tuple(chain)
    dj = _residues(rng, basis, (5, len(basis), p.n_ring), dev)
    keys = _residues(rng, basis, (10, len(basis), p.n_ring), dev)
    jobs.append(("relinearize part D=5", dj, keys, ck.sum_terms(5, 2),
                 basis))
    return jobs


def phase_ntt_fused(dev, rng) -> tuple[int, int]:
    """The fused kernel beyond one product a row: T-term sums (T = 1..4)
    with coefficient and NTT-domain right operands, the special prime,
    every cipher shape, runs longer than a run carries, and (smaller
    rings) two-term sums and the relinearize shape; the refusals.  Returns
    the jobs checked and the max_abs_err."""
    chain = BENCH_CKKS.primes + [BENCH_CKKS.special_prime]
    err, jobs = 0, 0
    for t in (1, 2, 3, 4):
        for primes, shape in ((chain, (3, 4, 1024)),
                              (BENCH_CKKS.special_prime, (5, 1024))):
            xs = [_residues(rng, primes if isinstance(primes, list)
                            else [primes], shape, dev) for _ in range(2 * t)]
            pr = primes if isinstance(primes, list) else primes
            terms = (tuple((s, t + s) for s in range(t)),)
            err = max(err, _mul_check(xs, [], terms, pr, f"T={t} coef"))
            err = max(err, _mul_check(xs[:t], xs[t:], terms, pr,
                                      f"T={t} NTT-domain"))
            jobs += 2
    for what, coef, ntt, terms, primes in _cipher_jobs(rng, dev):
        err = max(err, _mul_check(coef, ntt, terms, primes, what))
        jobs += 1
    for n, n_coef, n_out in ((1024, 8, 4), (4096, 3, 3), (8192, 2, 2)):
        q = CkksParams(n_ring=n, levels=2).primes[0]
        xs = [_residues(rng, [q], (3, n), dev) for _ in range(n_coef)]
        terms = tuple(tuple((i, (i + o) % n_coef) for i in range(n_coef))
                      for o in range(n_out))
        err = max(err, _mul_check(xs, [], terms, q, f"runs N={n}"))
        jobs += 1
    for n in NTT_RINGS:
        p = CkksParams(n_ring=n, levels=2)
        ps = p.primes + [p.special_prime]
        xs = [_residues(rng, ps, (r, 4, n), dev) for r in (3, 3, 3, 3, 3, 3)]
        err = max(err, _mul_check(xs[:4], [], (((0, 2), (1, 3)),), ps,
                                  f"T=2 N={n}"))
        err = max(err, _mul_check(xs[:2], xs[2:], ck.sum_terms(2, 2), ps,
                                  f"relinearize shape N={n}"))
        jobs += 2
    # refusals: an operand 8 bytes into its storage, and more coefficient
    # rows than a CTA's shared memory holds at N = 8192
    q = chain[0]
    odd = torch.zeros(2 * 1024 + 1, dtype=torch.int64, device=dev)[1:]
    good = _residues(rng, [q], (2, 1024), dev)
    for call in (lambda: nops.ntt_mul(odd.view(2, 1024), None,
                                      ck.ONE_TERM, q),
                 lambda: nops.mul_mod(odd.view(2, 1024), good, q)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a misaligned operand was taken")
    q13 = CkksParams(n_ring=8192, levels=2).primes[0]
    big = _residues(rng, [q13], (1, 8192), dev)
    try:
        nops.ntt_mul([big] * 6, [], (((0, 3), (1, 4), (2, 5)),), q13)
    except ValueError:
        pass
    else:
        raise AssertionError("ntt_mul took 6 coefficient rows at N=8192")
    # the standalone product with one stack of b for every stack of a
    a = _residues(rng, chain, (6, 4, 1024), dev)
    b = _residues(rng, chain, (4, 1024), dev)
    got = nops.mul_mod(a, b, chain)
    if not torch.equal(got, _ntt_plain("mul_mod", a, b.expand_as(a), chain)):
        raise AssertionError("mul_mod with a broadcast stack != plain")
    return jobs, err


def _schoolbook(a: list[int], b: list[int], q: int) -> list[int]:
    """O(N^2) negacyclic product in Python ints."""
    n = len(a)
    c = [0] * n
    for i in range(n):
        for j in range(n):
            k, v = i + j, a[i] * b[j]
            if k < n:
                c[k] = (c[k] + v) % q
            else:
                c[k - n] = (c[k - n] - v) % q
    return c


def phase_ntt_kernels(dev) -> dict:
    """Every NTT kernel against its plain version, bit for bit; returns
    each kernel's max_abs_err over the comparisons."""
    rng = np.random.default_rng(1024)
    errs = {k: 0 for k in NTT_KERNELS}
    chain = BENCH_CKKS.primes + [BENCH_CKKS.special_prime]
    cases = [(1024, [q], (r, 1024)) for q in chain
             for r in (1, 2, 3, 4, 6, 8, 12, 16, 24, 4096)]
    cases += [(1024, chain, (r, 4, 1024)) for r in (1, 3, 6, 12, 4096)]
    cases += [(1024, chain[:3], (r, 3, 1024)) for r in (1, 3, 8)]
    for n in NTT_RINGS:
        p = CkksParams(n_ring=n, levels=2)
        ps = p.primes + [p.special_prime]
        cases += [(n, ps, (r, 4, n)) for r in (1, 3, 5, 7)]
        cases += [(n, [ps[0]], (r, n)) for r in (1, 3, 5)]
    for n, primes, shape in cases:
        a = _residues(rng, primes, shape, dev)
        b = _residues(rng, primes, shape, dev)
        pr = primes if len(primes) > 1 else primes[0]
        for kind in NTT_KERNELS:
            got = _ntt_kernel(kind, a, b, pr)
            err = _max_abs_err((got,), (_ntt_plain(kind, a, b, pr),))
            errs[kind] = max(errs[kind], err)
            if err:
                raise AssertionError(f"{kind} != plain at N={n} primes "
                                     f"{primes} shape {shape}: "
                                     f"max_abs_err {err}")
        if not torch.equal(nops.ntt_inverse(nops.ntt_forward(a, pr), pr), a):
            raise AssertionError(f"inverse(forward(a)) != a at N={n}, "
                                 f"shape {shape}")
    q = CkksParams(n_ring=64).primes[0]
    a = _residues(rng, [q], (3, 64), dev)
    b = _residues(rng, [q], (3, 64), dev)
    c = nops.ntt_inverse(nops.mul_mod(nops.ntt_forward(a, q),
                                      nops.ntt_forward(b, q), q), q).cpu()
    for i in range(3):
        want = _schoolbook(a[i].tolist(), b[i].tolist(), q)
        if c[i].tolist() != want:
            raise AssertionError("negacyclic product != O(N^2) product")
    # the kernels read rows 16 bytes at a time: an operand that starts 8
    # bytes into an allocation is refused, not read misaligned
    odd = torch.zeros(2 * 1024 + 1, dtype=torch.int64, device=dev)[1:]
    for fn in (nops.ntt_forward, nops.ntt_inverse):
        try:
            fn(odd.view(2, 1024), chain[0])
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took a misaligned operand")
    c1 = ck.ntt.negacyclic_mul(a, b, q).cpu()
    if not torch.equal(c1, c):
        raise AssertionError("fused negacyclic product != O(N^2) product")
    jobs, err = phase_ntt_fused(dev, rng)
    errs["ntt_mul"] = max(errs["ntt_mul"], err)
    torch.cuda.synchronize()
    log(f"ntt kernels: ntt_forward, ntt_inverse, mul_mod and the fused "
        f"ntt_mul equal their plain versions bit for bit (tolerance 0: "
        f"integer arithmetic) in {len(cases)} cases: N=1024 at 1/2/3/4/6/8/"
        f"12/16/24/4096 rows for q0, q1, q2, P={BENCH_CKKS.special_prime}, "
        f"all four in one launch and the chain's three; N in {NTT_RINGS} at "
        f"odd row counts; round trips; negacyclic products at N=64 (three "
        f"launches and one fused) equal the O(N^2) product; a misaligned "
        f"operand refused")
    log(f"  ntt_mul in {jobs} more jobs: T-term sums T=1..4 (coefficient "
        f"and NTT-domain right operands; the chain and P stacked, and P "
        f"alone), every cipher shape at levels 2 and 1 (encrypt, decrypt "
        f"of 2 and 3 components, mul_tensor at 1, 5 and 24 groups, "
        f"relinearize, mul_plain), several runs at N=1024/4096/8192, two-"
        f"term sums and the relinearize shape at every other ring; "
        f"misaligned operands and 6 coefficient rows at N=8192 refused; "
        f"mul_mod with a broadcast stack")
    return errs


def _ckks_job(spec: dict, device) -> tuple:
    s = Session(JobSpec(**spec), device=device)
    t0 = time.perf_counter()
    out = s.execute(check=True)
    return s, out, time.perf_counter() - t0


def phase_ckks_parity(dev) -> dict:
    rows = {}
    for wl, n, ring, frames, prefetch in CKKS_PARITY:
        spec = dict(workload=wl, n=n, memory_budget=frames,
                    prefetch_pages=prefetch, ckks_ring=ring)
        gpu, out_g, t_g = _ckks_job(spec, dev)
        cpu, out_c, t_c = _ckks_job(spec, "cpu")
        if sorted(out_g) != sorted(out_c) or \
                not all(np.array_equal(out_g[k], out_c[k]) for k in out_g):
            raise AssertionError(f"{wl} ring {ring}: card and CPU outputs "
                                 f"differ")
        if not torch.equal(gpu.engines[0].memory.cpu(),
                           cpu.engines[0].memory):
            raise AssertionError(f"{wl} ring {ring}: card and CPU engine "
                                 f"memory differ")
        st = gpu.engine_stats[0]
        if st.swap_ins == 0:
            raise AssertionError(f"{wl} ring {ring}: no swaps")
        log(f"ckks parity: {wl} n={n} ring {ring} on the card ({t_g:.2f} s)"
            f" == on the CPU ({t_c:.2f} s): {len(out_g)} outputs and the "
            f"final engine memory bit for bit; swaps in/out "
            f"{st.swap_ins}/{st.swap_outs}")
        rows[f"{wl}-{ring}"] = {"card_s": t_g, "cpu_s": t_c}
    # relinearize at levels of more digits than one fused launch takes
    # (from 6: a launch for each part of the digits, summed)
    p = CkksParams(n_ring=1024, levels=5)
    gpu, cpu = (ck.CkksContext(p, seed=5, device=d) for d in (dev, "cpu"))
    rng = np.random.default_rng(5)
    for lvl in (5, 4):
        q = np.asarray(p.level_primes(lvl), dtype=np.int64)[:, None]
        ct3 = torch.from_numpy(rng.integers(0, 1 << 40, (3, lvl + 1, 1024))
                               % q)
        if not torch.equal(gpu.relinearize(ct3.to(dev), lvl).cpu(),
                           cpu.relinearize(ct3, lvl)):
            raise AssertionError(f"relinearize at level {lvl} of 5: card "
                                 f"and CPU differ")
    log(f"ckks parity: relinearize at levels 5 ({len(gpu._relin_keys[5])} "
        f"fused launches) and 4 (1) of a depth-5 chain on the card == on "
        f"the CPU")
    return rows


def expected_ntt_launches(s, levels: int) -> dict:
    """The NTT launches a CKKS job makes, from each worker's instruction
    mix, summed: each worker's key generation's 1 + levels forward
    transforms and products (s and s^2, then each level's key); one fused
    launch for each encryption (an INPUT
    that is not a plaintext), decryption (OUTPUT), relinearization
    (CT_RELIN, and CT_MUL's second), mul_plain (CT_MUL_PLAIN) and tensor
    product (CT_MUL, and each CT_MUL_NR call: a batched group of two or
    more instructions is one call, on the scalar loop each instruction
    is); no standalone inverse.  Up to levels
    4: from 6 digits a relinearization is a launch for each part of its
    digits (``CkksContext._key_chunks``)."""
    if levels > 4:
        raise ValueError(f"levels {levels}: relinearize's launches depend "
                         f"on each instruction's level")
    fused = 0
    for prog, eng in zip(s.plan(), s.engines):   # every worker's engine
        instrs = list(iter_instructions(prog))   # a program or its file
        ops_ = [ins.op for ins in instrs]
        n_in = sum(1 for ins in instrs
                   if ins.op == Op.INPUT and ins.imm[1] != 1)
        mul_nr = ops_.count(Op.CT_MUL_NR)
        sched = eng.overlap_schedule or eng.batch_schedule
        if sched is not None:       # the scalar loop makes a call each
            sizes = np.diff(sched.bounds)
            local = getattr(sched, "group_kind", np.zeros_like(sizes)) == 0
            batched = sizes[local & (sched.group_op == int(Op.CT_MUL_NR)) &
                            (sizes >= 2)]
            mul_nr -= int((batched - 1).sum())
        fused += (n_in + ops_.count(Op.OUTPUT) + ops_.count(Op.CT_RELIN) +
                  2 * ops_.count(Op.CT_MUL) + ops_.count(Op.CT_MUL_PLAIN) +
                  mul_nr)
    keys = len(s.engines) * (1 + levels)   # each worker's key generation
    return {"ntt_forward": keys, "ntt_inverse": 0, "mul_mod": keys,
            "ntt_mul": fused}


def _ckks_checked_run(spec: dict, dev) -> tuple:
    """Run one CKKS job with the NTT counters set to 0 just before it and
    read just after; check that every transform and product the cipher
    asked for went through a kernel, in the launches its instruction mix
    gives (every kind the job needs launched, the fused one among them)."""
    nops.reset_counts()
    s, out, seconds = _ckks_job(spec, dev)
    counts = nops.counts()
    asked = {k: s.ckks_counts.get(k, 0) for k in NTT_KERNELS}
    if counts["rows"] != asked:
        raise AssertionError(f"rows through the kernels {counts['rows']} "
                             f"!= rows the cipher asked for {asked}")
    if any(counts["plain_calls"].values()):
        raise AssertionError(f"plain versions ran: {counts['plain_calls']}")
    want = expected_ntt_launches(s, spec["ckks_levels"])
    if counts["launches"] != want or not want["ntt_mul"]:
        raise AssertionError(f"launches {counts['launches']} != {want}, "
                             f"what the instruction mix gives")
    return s, out, seconds, counts


def phase_ckks_main(dev) -> tuple[dict, dict, dict]:
    """The CKKS main path; returns the NTT kernels' counts from its run,
    its end-to-end metrics and its outputs."""
    torch.cuda.reset_peak_memory_stats(dev)
    s, out, seconds, counts = _ckks_checked_run(CKKS_MAIN, dev)
    rep = s.plan_reports[0].replacement
    st = s.engine_stats[0]
    swaps = (st.swap_ins, st.swap_outs)
    if (rep.swap_ins, rep.swap_outs) != CKKS_MAIN_SWAPS or \
            swaps != CKKS_MAIN_SWAPS:
        raise AssertionError(f"swaps {swaps} (plan {rep.swap_ins}/"
                             f"{rep.swap_outs}) != {CKKS_MAIN_SWAPS}")
    t = s.timings
    he = homomorphic_ops(s.op_counts)
    log(f"ckks main: rmvmul n={CKKS_MAIN['n']} at ring 1024, levels 2, "
        f"budget {CKKS_MAIN['memory_budget']} ({s.config.num_frames} frames,"
        f" {s.config.prefetch_pages} prefetch), {len(out)} outputs checked "
        f"against the oracle (atol 2e-2)")
    log(f"  seconds: trace {t['trace_s']:.3f}, plan {t['plan_s']:.3f}, "
        f"batch schedule {t['batch_schedule_s']:.3f}, execute "
        f"{t['execute_s']:.3f} (keygen {t['keygen_s']:.3f}; all "
        f"{seconds:.3f})")
    log(f"  instructions {st.instructions} ({s.op_counts}), {he} "
        f"homomorphic ops, {he / t['execute_s']:.1f} per second")
    log(f"  swaps: {swaps[0]} in / {swaps[1]} out, {st.io_read_bytes} / "
        f"{st.io_write_bytes} bytes; frame memory {st.frame_bytes} bytes, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)}")
    log(f"  rows through the kernels (== the cipher's count) "
        f"{counts['rows']}, launches {counts['launches']}")
    metrics = {"n": CKKS_MAIN["n"], **t, "instructions": st.instructions,
               "op_counts": s.op_counts, "he_ops": he,
               "he_ops_per_s": he / t["execute_s"], "swaps": list(swaps),
               "swap_bytes": [st.io_read_bytes, st.io_write_bytes],
               "rows": counts["rows"], "launches": counts["launches"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    s2, out2, sec2, c2 = _ckks_checked_run(CKKS_STATS, dev)
    st2 = s2.engine_stats[0]
    log(f"ckks rstats: n={CKKS_STATS['n']} at the same width, {len(out2)} "
        f"outputs checked against the oracle, execute "
        f"{s2.timings['execute_s']:.3f} s, {st2.instructions} instructions "
        f"({s2.op_counts}), swaps {st2.swap_ins}/{st2.swap_outs}, rows "
        f"{c2['rows']}")
    metrics["rstats"] = {"n": CKKS_STATS["n"], **s2.timings,
                         "instructions": st2.instructions,
                         "swaps": [st2.swap_ins, st2.swap_outs],
                         "rows": c2["rows"]}
    return counts, metrics, out


def _ntt_work(kind: str, rows: int, n: int) -> tuple[int, int]:
    """(integer operations, bytes) of one launch over rows of one prime."""
    if kind == "mul_mod":
        return nk.mul_mod_ops(rows, n), nk.mul_mod_bytes(rows, n, 1)
    return (nk.transform_ops(rows, n, kind == "ntt_inverse"),
            nk.transform_bytes(rows, n, 1))


def _ntt_timing(kind: str, rows: int, n: int, dev, rng, reps: int) -> dict:
    """One launch size: kernel, plain and (product) library times, and
    the bound, on rows of q1; checks the kernel against the plain version
    on the same inputs."""
    q = BENCH_CKKS.primes[1]
    a = _residues(rng, [q], (rows, n), dev)
    b = _residues(rng, [q], (rows, n), dev)
    qcol = torch.full((1, 1), q, dtype=torch.int64, device=dev)
    kfn = lambda: _ntt_kernel(kind, a, b, q)  # noqa: E731
    pfn = lambda: _ntt_plain(kind, a, b, q)  # noqa: E731
    err = _max_abs_err((kfn(),), (pfn(),))
    if err:
        raise AssertionError(f"{kind} != plain at {rows} rows: {err}")
    ops_n, bytes_n = _ntt_work(kind, rows, n)
    host_ms = _device_ms(kfn, reps)
    ms = _kernel_ms(kfn, NTT_KERNELS[kind][0], reps) or host_ms
    return {"ms": ms, "host_ms": host_ms,
            "plain_ms": _device_ms(pfn, max(reps // 20, 5)),
            # the same product as one PyTorch expression: two calls
            "library_ms": _device_ms(lambda: (a * b) % qcol, reps)
            if kind == "mul_mod" else None,
            "ops_ms": ops_n / INT_OPS_PER_S * 1e3,
            "bytes_ms": bytes_n / HBM_BYTES_PER_S * 1e3, "err": err}


def _mul_timing(key: tuple, n: int, dev, rng, reps: int,
                replaced: bool = True) -> dict:
    """One fused launch shape ``key`` = (n_coef, n_ntt, terms, groups, P)
    at ring n: the kernel's device time (profiler) and the host's pace
    (events), the plain version, the bound and, beside them, the three
    standalone launches the fused one replaces at the same sizes (forward
    of the coefficient rows, the products, the inverse of the outputs),
    each timed alone; checks the kernel against the plain version."""
    n_coef, n_ntt, terms, groups, P = key
    chain = BENCH_CKKS.primes + [BENCH_CKKS.special_prime]
    primes = tuple(chain[:P]) if P > 1 else (BENCH_CKKS.primes[1],)
    coef = _residues(rng, list(primes), (groups, n_coef, P, n), dev)
    ntt = _residues(rng, list(primes), (n_ntt, P, n), dev) if n_ntt \
        else None
    kfn = lambda: nops.ntt_mul(coef, ntt, terms, primes)  # noqa: E731
    pfn = lambda: _mul_plain(coef, ntt, terms, primes)  # noqa: E731
    err = _max_abs_err((kfn(),), (pfn(),))
    if err:
        raise AssertionError(f"ntt_mul != plain at {key}: {err}")
    ctas, n_out = groups * P, len(terms)
    n_terms = sum(len(t) for t in terms)
    host_ms = _device_ms(kfn, reps)
    out = {"ms": _kernel_ms(kfn, NTT_KERNELS["ntt_mul"][0], reps) or host_ms,
           "host_ms": host_ms,
           "plain_ms": _device_ms(pfn, max(reps // 40, 3)),
           "ops_ms": nk.ntt_mul_ops(n_coef, n_terms, n_out, ctas, n)
           / INT_OPS_PER_S * 1e3,
           "bytes_ms": nk.ntt_mul_bytes(n_coef + n_ntt, n_out, ctas, n, P)
           / HBM_BYTES_PER_S * 1e3, "err": err}
    if replaced:
        rows = {"ntt_forward": ctas * n_coef, "mul_mod": ctas * n_terms,
                "ntt_inverse": ctas * n_out}
        out["unfused"] = {}
        for kind in UNFUSED:
            a = _residues(rng, [primes[0]], (rows[kind], n), dev)
            fn = lambda: _ntt_kernel(kind, a, a, primes[0])  # noqa: E731
            out["unfused"][kind] = _kernel_ms(fn, NTT_KERNELS[kind][0],
                                              reps) or _device_ms(fn, reps)
        out["unfused_ms"] = sum(out["unfused"].values())
    return out


def _ntt_wrapper_costs(dev, reps: int = 2000) -> dict:
    """Host µs of the pieces of a forward wrapper call on 12 rows of
    N = 1024 (4 stacks of the chain's three primes, a common launch before
    the fused product), each on the host's clock over back-to-back calls
    (median of five rounds taken in turns): the operand's checks; the
    primes' checks and the table lookup that every call made before they
    were remembered, and the one lookup of both that it makes now; the
    output's allocation; the current stream as a torch.cuda.Stream object
    (as the wrapper read it before) and as the raw handle it reads now;
    the ctypes call alone (no rows: it launches nothing); the whole call,
    as it is and with the remembered primes forgotten before each call;
    and a whole fused call of the encryption's shape and of the tensor
    product's."""
    primes = tuple(BENCH_CKKS.primes)
    a = _residues(np.random.default_rng(3), primes, (4, 3, 1024), dev)
    s = _residues(np.random.default_rng(4), primes, (1, 3, 1024), dev)
    lib = nk.library()
    t = nops.tables(primes, 1024, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr, tw, cs = a.data_ptr(), t.tw.data_ptr(), t.consts.data_ptr()

    def forgotten():
        nops._prepared.clear()
        return nops.ntt_forward(a, primes)
    pieces = {
        "check": lambda: nops._check(a, "a"),
        "validate_and_tables": lambda: nops.tables(
            nops._validate(primes, 1024), 1024, a.device),
        "prepare": lambda: nops._prepare(a, primes),
        "output": lambda: torch.empty_like(a),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream": lambda: nk._stream(a),
        "ctypes": lambda: lib.ntt_forward(ptr, ptr, tw, cs, 3, 10, 0,
                                          stream),
        "call": lambda: nops.ntt_forward(a, primes),
        "call_validating": forgotten,
        "fused_encrypt": lambda: nops.ntt_mul(a[:1], s, ck.ONE_TERM,
                                              primes),
        "fused_tensor": lambda: nops.ntt_mul(a, None, ck.TENSOR_TERMS,
                                             primes),
    }
    return _host_us(pieces, reps)


def _replaced_sizes(shapes: dict) -> dict:
    """The standalone launches the fused launches replace, by kind: rows
    -> launches."""
    out = {k: {} for k in UNFUSED}
    for (n_coef, _, terms, groups, P), k in shapes.items():
        ctas = groups * P
        for kind, r in (("ntt_forward", ctas * n_coef),
                        ("mul_mod", ctas * sum(len(t) for t in terms)),
                        ("ntt_inverse", ctas * len(terms))):
            out[kind][r] = out[kind].get(r, 0) + k
    return out


def ntt_record(dev, paths: dict, errs: dict) -> tuple[list[dict], dict]:
    """Each NTT kernel at every launch size of each CKKS path's run,
    launch-weighted as kernel_record does (device time from the profiler,
    the host's pace per back-to-back wrapper call from events), and at
    4096 rows, beside the empty kernel's floor, the clocks and a host
    breakdown of a wrapper call.  ``paths`` holds each path's counters,
    the CKKS main path first: a row carries its launches and means, and
    ``by_path`` each path's own.  A standalone kernel that a path no
    longer launches (the inverse) is weighted over the sizes that its
    fused launches replace.  The fused kernel is weighted over its launch
    shapes and set beside the three launches it replaces, timed at the
    same sizes."""
    rng = np.random.default_rng(12)
    n = BENCH_CKKS.n_ring
    rows_out = []
    big = {"empty": _empty_launch(dev, 200), "clocks": _clocks()}
    log(f"  clocks (sm, max sm, temperature, power): {big['clocks']}")
    log(f"  empty kernel (the launch floor): {big['empty']['ms']} ms "
        f"(profiler), {big['empty']['host_ms']:.5f} ms per call (events)")
    timed = {}        # (kind, rows) or the fused shape -> its timing

    def weigh(sizes: dict, one, keys) -> dict:
        total = sum(sizes.values())
        acc = dict.fromkeys(keys, 0.0)
        for r, k in sizes.items():
            t = one(r)
            for key in acc:
                acc[key] += k / total * (t[key] or 0.0)
        acc["bound_ms"] = max(acc["ops_ms"], acc["bytes_ms"])
        acc["bound_by"] = "operations" if acc["ops_ms"] >= acc["bytes_ms"] \
            else "bytes"
        return acc

    def path_entry(launches: int, acc: dict) -> dict:
        return {"launches": launches,
                **{k: acc[k] for k in ("ms", "plain_ms", "bound_ms")}}

    main_path = next(iter(paths))
    for kind in UNFUSED:
        kname, replaces = NTT_KERNELS[kind]

        def one(r, kind=kind):
            if (kind, r) not in timed:
                timed[kind, r] = _ntt_timing(kind, r, n, dev, rng, 200)
            return timed[kind, r]
        by_path = {}
        for path, counts in paths.items():
            own = counts["launch_sizes"][kind]
            sizes = own or _replaced_sizes(counts["mul_shapes"])[kind]
            acc = weigh(sizes, one, ("ms", "host_ms", "plain_ms",
                                     "library_ms", "ops_ms", "bytes_ms"))
            by_path[path] = (acc, path_entry(counts["launches"][kind], acc))
            log(f"  {kind} over "
                + (f"the {path} path's launch sizes" if own else
                   f"the sizes the {path} path's fused launches replace (it "
                   f"launches it no more)")
                + f" {dict(sorted(sizes.items()))}: {acc['ms']:.6f} ms per "
                f"launch (bound {acc['bound_ms']:.3e} ms, plain "
                f"{acc['plain_ms']:.4f} ms"
                + (f", (a * b) % q {acc['library_ms']:.4f} ms"
                   if kind == "mul_mod" else "") + f"), "
                f"{acc['host_ms']:.5f} ms per wrapper call (events)")
        acc = by_path[main_path][0]
        at4k = _ntt_timing(kind, 4096, n, dev, rng, 50)
        big[kind] = at4k
        rows_out.append({
            "name": kind, "route": "cuda",
            "source": "src/repro_torch/kernels/ntt/csrc/ntt.cu",
            "replaces": replaces,
            "launches": paths[main_path]["launches"][kind],
            "max_abs_err": float(errs[kind]),
            "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
            "library_ms": acc["library_ms"] if kind == "mul_mod" else None,
            "by_path": {p: e for p, (_, e) in by_path.items()}})
        big[f"{kind}_main"] = {k: acc[k] for k in ("ms", "host_ms",
                                                   "plain_ms", "bound_ms")}
        b4k = max(at4k["ops_ms"], at4k["bytes_ms"])
        by = "operations" if at4k["ops_ms"] >= at4k["bytes_ms"] else "bytes"
        log(f"  {kind} at 4096 rows of N=1024: {at4k['ms']:.5f} ms (bound "
            f"{b4k:.4f} ms by {by}, {b4k / at4k['ms']:.3g} of it), plain "
            f"{at4k['plain_ms']:.4f} ms"
            + (f", (a * b) % q {at4k['library_ms']:.4f} ms"
               if kind == "mul_mod" else "")
            + f", {at4k['host_ms']:.5f} ms per wrapper call (events)")
        if kind == "mul_mod":
            for r in (2, 12, 24):
                one = _ntt_timing(kind, r, n, dev, rng, 200)
                big[f"mul_mod_{r}"] = one["ms"]
            log(f"  mul_mod at 2 / 12 / 24 rows: {big['mul_mod_2']:.6f} / "
                f"{big['mul_mod_12']:.6f} / {big['mul_mod_24']:.6f} ms")

    # the fused kernel, over each path's shapes, against what it replaces
    def fused(key):
        if key not in timed:
            timed[key] = _mul_timing(key, n, dev, rng, 200)
            t = timed[key]
            log(f"  ntt_mul shape (coef {key[0]}, ntt {key[1]}, outputs "
                f"{len(key[2])}, groups {key[3]}, primes {key[4]}): "
                f"{t['ms']:.6f} ms against {t['unfused_ms']:.6f} for the "
                f"three it replaces ({', '.join(f'{u} {v:.6f}' for u, v in t['unfused'].items())})")
        return timed[key]
    fused_by_path = {}
    for path, counts in paths.items():
        shapes = counts["mul_shapes"]
        acc = weigh(shapes, fused, ("ms", "host_ms", "plain_ms", "ops_ms",
                                    "bytes_ms", "unfused_ms"))
        fused_by_path[path] = (acc, path_entry(counts["launches"]["ntt_mul"],
                                               acc))
        log(f"  ntt_mul over the {path} path's launch shapes "
            f"{[[list(k[:2]) + [len(k[2])] + list(k[3:]), v] for k, v in shapes.items()]}"
            f": {acc['ms']:.6f} ms per launch against "
            f"{acc['unfused_ms']:.6f} for the three launches it replaces "
            f"(bound {acc['bound_ms']:.3e} ms, plain {acc['plain_ms']:.4f} "
            f"ms), {acc['host_ms']:.5f} ms per wrapper call (events)")
    acc = fused_by_path[main_path][0]
    shapes = paths[main_path]["mul_shapes"]
    per_shape = [[list(key[:2]) + [len(key[2])] + list(key[3:]), k,
                  timed[key]["ms"], timed[key]["unfused_ms"],
                  timed[key]["unfused"]]
                 for key, k in sorted(shapes.items(), key=lambda kv: -kv[1])]
    at4k = _mul_timing((2, 0, ck.ONE_TERM, 4096, 1), n, dev, rng, 50)
    b4k = max(at4k["ops_ms"], at4k["bytes_ms"])
    big["ntt_mul"] = at4k
    big["ntt_mul_main"] = {**acc, "shapes": per_shape,
                           "ratio": acc["ms"] / acc["unfused_ms"]}
    rows_out.append({
        "name": "ntt_mul", "route": "cuda",
        "source": "src/repro_torch/kernels/ntt/csrc/ntt.cu",
        "replaces": NTT_KERNELS["ntt_mul"][1],
        "launches": paths[main_path]["launches"]["ntt_mul"],
        "max_abs_err": float(errs["ntt_mul"]),
        "ms": acc["ms"], "plain_ms": acc["plain_ms"],
        "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
        "library_ms": None,
        "by_path": {p: e for p, (_, e) in fused_by_path.items()}})
    log(f"  ntt_mul at 4096 output rows of N=1024 (two coefficient rows "
        f"each): {at4k['ms']:.5f} ms (bound {b4k:.4f} ms by "
        f"{'operations' if at4k['ops_ms'] >= at4k['bytes_ms'] else 'bytes'}"
        f", {b4k / at4k['ms']:.3g} of it) against {at4k['unfused_ms']:.5f} "
        f"for the three launches ({', '.join(f'{u} {v:.5f}' for u, v in at4k['unfused'].items())}), "
        f"plain {at4k['plain_ms']:.4f} ms, {at4k['host_ms']:.5f} ms per "
        f"wrapper call (events)")
    big["wrapper_us"] = _ntt_wrapper_costs(dev)
    log("  host µs per piece of a forward wrapper call on 12 rows (host "
        "clock, back to back), and of two fused calls: " + ", ".join(
            f"{k} {v:.2f}" for k, v in big["wrapper_us"].items()))
    return rows_out, big


def phase_ckks_profile(dev) -> dict:
    """The CKKS main job under torch.profiler: device time by op and the
    busy share of the execute stage (a lower bound on the unprofiled
    run's, since the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    s = Session(JobSpec(**CKKS_MAIN), device=dev)
    s.plan()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.execute(check=True)
    wall_ms = s.timings["execute_s"] * 1e3
    evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in evs) / 1e3
    log(f"ckks profile: rmvmul n={CKKS_MAIN['n']}, execute {wall_ms:.1f} ms "
        f"under the profiler, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.3f} of it; idle share "
        f"{1 - busy_ms / wall_ms:.3f})")
    top = []
    for e in evs[:10]:
        log(f"  {_dev_us(e) / 1e3:10.2f} ms  {e.count:8d}x  {e.key[:70]}")
        top.append([e.key[:60], _dev_us(e) / 1e3, e.count])
    return {"execute_ms": wall_ms, "busy_ms": busy_ms, "top": top}

# ---------------------------------------------------------------------------
# the baselines: unbounded memory, the eviction policies and swap bypass, the
# scalar engine loop, the swap file
# ---------------------------------------------------------------------------

#: the GC main job unbounded: the traced program over the whole virtual
#: address space (no budget, no swap directive)
MAIN_UNBOUNDED = dict(n=MAIN["n"], plan_mode="unbounded")
#: the CKKS main job unbounded
CKKS_UNBOUNDED = dict(workload="rmvmul", n=CKKS_MAIN["n"],
                      plan_mode="unbounded", ckks_ring=1024, ckks_levels=2)
#: the policies' GC job: the main job's shape at a sixteenth of its size
POLICY_GC = dict(n=512, memory_budget=0.4, lookahead=10_000,
                 prefetch_pages=4)
#: (policy, swap_bypass, prefetch pages or None for the job's) -> the JAX
#: package's scalar-core plan of POLICY_GC and of CKKS_MAIN: (swap-ins,
#: swap-outs, prefetched, bypass hits)
POLICY_PLANS = {
    ("min", False, None): ((176, 176, 176, 0), (646, 309, 646, 0)),
    ("min_clean", False, None): ((176, 176, 176, 0), (646, 309, 646, 0)),
    ("lru", False, None): ((235, 235, 235, 0), (908, 390, 908, 0)),
    ("fifo", False, None): ((235, 235, 235, 0), (1004, 486, 1004, 0)),
    ("min", True, None): ((176, 176, 172, 4), (646, 309, 640, 6)),
    ("lru", False, 0): ((233, 233, 0, 0), (861, 365, 0, 0)),
}
#: card-against-CPU jobs of the new path: the ckks parity phase's rmvmul
#: jobs unbounded, and on the scalar loop at their budgets
BASELINE_PARITY = [
    (wl, n, ring, knobs) for wl, n, ring, frames, prefetch in CKKS_PARITY
    if wl == "rmvmul"
    for knobs in (dict(plan_mode="unbounded"),
                  dict(memory_budget=frames, prefetch_pages=prefetch,
                       exec_backend="scalar"))]


def _same(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and \
        all(np.array_equal(a[k], b[k]) for k in a)


def _gc_checked_run(job: dict, dev) -> tuple:
    """Run one GC merge job with the half-gates counters set to 0 just
    before it and read just after; check that every AND gate of both
    parties went through the kernels."""
    ops.reset_counts()
    s, out, seconds = _run(job, dev)
    c = ops.counts()
    ands = tuple(g.ands for g in s.gate_counts)
    if (c["garble_ands"], c["eval_ands"]) != ands or not ands[0]:
        raise AssertionError(f"ANDs through the kernels {c} != gate counts "
                             f"{ands}")
    return s, out, seconds, c


def _no_swaps(s) -> None:
    """An unbounded run: no swap directive in any worker's program or
    engine (its only directives are NET_* ones)."""
    if any(p.phase != "virtual" or any(ins.op in SWAP_DIRECTIVES
                                       for ins in p.instrs)
           for p in s.plan()):
        raise AssertionError("the unbounded program holds swap directives")
    if any(e.directives != e.net_messages or e.swap_ins or e.swap_outs
           or e.io_read_bytes for e in s.engine_stats):
        raise AssertionError("the unbounded run swapped")


def _baseline_gc_main(dev, main_out: dict, planned: dict) -> dict:
    # the peak above what earlier phases still hold (the served model)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    s, out, seconds, c = _gc_checked_run(MAIN_UNBOUNDED, dev)
    _no_swaps(s)
    if not _same(out, main_out):
        raise AssertionError("unbounded GC main outputs != the main phase's")
    ands = s.gate_counts[0].ands
    if ands != planned["ands"]:
        raise AssertionError(f"unbounded ANDs {ands} != planned "
                             f"{planned['ands']}")
    t = s.timings["execute_s"]
    mem = torch.cuda.max_memory_allocated(dev) - held
    fb = s.engine_stats[0].frame_bytes
    ratio = planned["execute_s"] / t
    log(f"baselines: GC main unbounded, merge n={MAIN['n']} per party, "
        f"{len(out)} output chunks checked against the oracle and equal to "
        f"the main phase's; 0 swap directives; {ands} AND gates per party "
        f"(== planned), all through the kernels ({c['garble_launches']} / "
        f"{c['eval_launches']} launches)")
    log(f"  execute {t:.3f} s ({ands / t:.4e} AND gates/s) against planned "
        f"{planned['execute_s']:.3f} s ({planned['ands_per_s']:.4e}): "
        f"planned / unbounded execute {ratio:.4f}")
    log(f"  frame bytes per party: unbounded {fb}, planned "
        f"{planned['frame_bytes']}; max_memory_allocated unbounded {mem} "
        f"(above the {held} bytes held before it), planned "
        f"{planned['max_memory_allocated']}")
    return {"execute_s": t, "ands_per_s": ands / t, "all_s": seconds,
            "planned_over_unbounded": ratio, "frame_bytes": fb,
            "planned_frame_bytes": planned["frame_bytes"],
            "max_memory_allocated": mem,
            "planned_max_memory_allocated": planned["max_memory_allocated"],
            "launches": [c["garble_launches"], c["eval_launches"]]}


def _baseline_ckks_turns(dev) -> tuple[dict, dict]:
    """The CKKS main job planned and unbounded in turns, three rounds;
    returns the metrics and the last planned run (session, outputs)."""
    runs = {"planned": [], "unbounded": []}
    info = {}
    for _ in range(3):
        for name, spec in (("planned", CKKS_MAIN),
                           ("unbounded", CKKS_UNBOUNDED)):
            s, out, _, c = _ckks_checked_run(spec, dev)
            if name == "unbounded":
                _no_swaps(s)
            else:
                last = (s, out)
            runs[name].append(s.timings["execute_s"])
            info[name] = {"frame_bytes": s.engine_stats[0].frame_bytes,
                          "launches": c["launches"]}
    med = {k: statistics.median(v) for k, v in runs.items()}
    ratio = med["planned"] / med["unbounded"]
    log(f"baselines: CKKS main rmvmul n={CKKS_MAIN['n']}, ring 1024, in "
        f"turns (planned, unbounded) x 3, outputs checked against the "
        f"oracle: execute s planned {runs['planned']}, unbounded "
        f"{runs['unbounded']}; medians {med['planned']:.4f} / "
        f"{med['unbounded']:.4f} (planned / unbounded {ratio:.4f})")
    for k, v in info.items():
        log(f"  {k}: frame bytes {v['frame_bytes']}, launches "
            f"{v['launches']} (as the instruction mix gives)")
    return {"execute_s": runs, "medians": med,
            "planned_over_unbounded": ratio,
            **{f"{k}_frame_bytes": v["frame_bytes"] for k, v in info.items()},
            "fused_launches": {k: v["launches"]["ntt_mul"]
                               for k, v in info.items()}}, last


def _check_plan(s, want: tuple, what: str) -> None:
    """The plan's swaps equal the JAX package's, and every engine ran each
    of the program's swap-ins and swap-outs."""
    r = s.plan_reports[0]
    got = (r.replacement.swap_ins, r.replacement.swap_outs,
           r.schedule.prefetched, r.schedule.bypass_hits)
    if got != want:
        raise AssertionError(f"{what}: plan {got} != the reference's {want}")
    ops_ = [ins.op for ins in s.plan()[0].instrs]
    moves = (ops_.count(Op.SWAP_IN) + ops_.count(Op.ISSUE_SWAP_IN),
             ops_.count(Op.SWAP_OUT) + ops_.count(Op.ISSUE_SWAP_OUT))
    for e in s.engine_stats:
        if (e.swap_ins, e.swap_outs) != moves:
            raise AssertionError(f"{what}: the engine swapped "
                                 f"{e.swap_ins}/{e.swap_outs}, the program "
                                 f"holds {moves}")


def _baseline_policies(dev) -> tuple[dict, tuple]:
    """Every policy and swap bypass at the GC and CKKS jobs; returns their
    swap counts and times, and the GC "min" run (the batched, pinned-RAM
    comparator of the scalar and swap-file runs)."""
    rows = {}
    for (policy, bypass, prefetch), (gc_want, ck_want) in \
            POLICY_PLANS.items():
        name = policy + ("+bypass" if bypass else "") + \
            ("" if prefetch is None else f" prefetch {prefetch}")
        knobs = dict(policy=policy, swap_bypass=bypass)
        if prefetch is not None:
            knobs["prefetch_pages"] = prefetch
        gc = _gc_checked_run({**POLICY_GC, **knobs}, dev)
        _check_plan(gc[0], gc_want, f"merge n={POLICY_GC['n']} {name}")
        ck = _ckks_checked_run({**CKKS_MAIN, **knobs}, dev)
        _check_plan(ck[0], ck_want, f"ckks main {name}")
        if (policy, bypass, prefetch) == ("min", False, None):
            gc_min = gc
        rows[name] = {"gc_swaps": list(gc_want),
                      "gc_execute_s": gc[0].timings["execute_s"],
                      "ckks_swaps": list(ck_want),
                      "ckks_execute_s": ck[0].timings["execute_s"]}
        log(f"baselines: {name}: merge n={POLICY_GC['n']} swaps (in, out, "
            f"prefetched, "
            f"bypassed) {gc_want}, execute {rows[name]['gc_execute_s']:.3f}"
            f" s; ckks main {ck_want}, execute "
            f"{rows[name]['ckks_execute_s']:.3f} s; outputs checked")
    return rows, gc_min


def _baseline_scalar(dev, gc_min: tuple, ckks_planned: tuple) -> dict:
    """The scalar engine loop against the batched one on the same jobs."""
    res = {}
    for name, (bs, bout, _, bc), run in (
            ("gc", gc_min, lambda: _gc_checked_run(
                dict(POLICY_GC, exec_backend="scalar"), dev)),
            ("ckks", (*ckks_planned, None, None), lambda: _ckks_checked_run(
                dict(CKKS_MAIN, exec_backend="scalar"), dev))):
        s, out, _, c = run()
        if not _same(out, bout):
            raise AssertionError(f"{name}: scalar outputs != batched")
        if name == "gc":
            ands = [g.ands for g in s.gate_counts]
            if ands != [g.ands for g in bs.gate_counts]:
                raise AssertionError(f"scalar ANDs {ands} != batched")
            launches = {"scalar": c["garble_launches"],
                        "batched": bc["garble_launches"]}
        else:
            launches = {"scalar": c["launches"]["ntt_mul"],
                        "batched": expected_ntt_launches(
                            bs, 2)["ntt_mul"]}
        secs = {"scalar": s.timings["execute_s"],
                "batched": bs.timings["execute_s"]}
        res[name] = {"execute_s": secs, "launches": launches}
        log(f"baselines: scalar loop, {name}: outputs == batched; execute "
            f"s scalar {secs['scalar']:.3f}, batched {secs['batched']:.3f}; "
            f"{'garble' if name == 'gc' else 'fused'} launches {launches}")
        if name == "gc":
            res["gc_unbounded"] = _unbounded_both_loops(dev, bout, secs)
    return res


def _unbounded_both_loops(dev, planned_out: dict, planned_s: dict) -> dict:
    """The policies' GC job unbounded on both engine loops, beside its
    planned runs: which loop the planned / unbounded ratio comes from."""
    res = {}
    for loop in ("scalar", "batched"):
        s, out, _, c = _gc_checked_run(
            dict(n=POLICY_GC["n"], plan_mode="unbounded",
                 exec_backend=loop), dev)
        _no_swaps(s)
        if not _same(out, planned_out):
            raise AssertionError(f"merge n={POLICY_GC['n']} unbounded on "
                                 f"the {loop} loop != planned")
        t = s.timings["execute_s"]
        res[loop] = {"execute_s": t, "garble_launches": c["garble_launches"],
                     "planned_over_unbounded": planned_s[loop] / t}
        log(f"  merge n={POLICY_GC['n']} unbounded, {loop} loop: execute "
            f"{t:.3f} s, {c['garble_launches']} garble launches; planned / "
            f"unbounded {planned_s[loop] / t:.4f}")
    return res


def _baseline_memmap(dev, gc_min: tuple, ckks_planned: tuple) -> dict:
    """The swap file against pinned host pages on the same jobs."""
    res = {}
    for name, ram, run in (
            ("gc", gc_min[:2], lambda: _gc_checked_run(
                dict(POLICY_GC, storage="memmap"), dev)),
            ("ckks", ckks_planned, lambda: _ckks_checked_run(
                dict(CKKS_MAIN, storage="memmap"), dev))):
        s, out, _, _ = run()
        if not _same(out, ram[1]):
            raise AssertionError(f"{name}: memmap outputs != ram")
        swaps = [_swaps(x) for x in (s, ram[0])]
        if swaps[0] != swaps[1] or not swaps[0][0]:
            raise AssertionError(f"{name}: memmap swaps {swaps[0]} != ram "
                                 f"{swaps[1]}")
        left = [st.path for st in s.storages if os.path.exists(st.path)]
        if left:
            raise AssertionError(f"swap files left behind: {left}")
        secs = {"memmap": s.timings["execute_s"],
                "ram": ram[0].timings["execute_s"]}
        res[name] = {"execute_s": secs, "swaps": list(swaps[0])}
        log(f"baselines: swap file, {name}: outputs, swaps and bytes "
            f"{swaps[0]} == ram; file removed; execute s memmap "
            f"{secs['memmap']:.3f}, ram {secs['ram']:.3f}")
    return res


def _baseline_parity_runs(device) -> dict:
    """The new path's parity jobs on ``device``: the CKKS jobs with their
    final engine memory, the unbounded merge with its AND counts and table
    digest."""
    res = {}
    for wl, n, ring, knobs in BASELINE_PARITY:
        s, out, t = _ckks_job(dict(workload=wl, n=n, ckks_ring=ring,
                                   **knobs), device)
        res[f"{wl}-{ring}-{knobs.get('plan_mode', 'scalar')}"] = {
            "outputs": out, "memory": _memory_digest(s), "s": t}
    job = dict(PARITY, memory_budget=None, prefetch_pages=0,
               plan_mode="unbounded")
    s, out, t = _run(job, device, digest=True)
    _no_swaps(s)
    res["merge-unbounded"] = {"outputs": out, "digest": s.table_digest,
                              "ands": [g.ands for g in s.gate_counts],
                              "s": t}
    return res


def baseline_parity_cpu() -> dict:
    """The baselines phase's parity jobs with device="cpu", what the card's
    runs are held to.  ``main`` runs them in a process of its own (one
    thread) from the top, and the baselines phase collects them."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = _baseline_parity_runs("cpu")
    res["cpu_s"] = time.perf_counter() - t0
    return res


def _baseline_parity(dev, cpu) -> dict:
    """The new path on the card against device="cpu", bit for bit (the
    CPU's runs from ``cpu``, an async result of baseline_parity_cpu)."""
    got = _baseline_parity_runs(dev)
    want = cpu.get()
    res = {}
    for key, g in got.items():
        w = want[key]
        if not _same(g["outputs"], w["outputs"]):
            raise AssertionError(f"{key}: card and CPU outputs differ")
        if key == "merge-unbounded":
            if g["digest"] != w["digest"] or g["ands"] != w["ands"]:
                raise AssertionError("unbounded merge: card and CPU differ")
        elif g["memory"] != w["memory"]:
            raise AssertionError(f"{key}: card and CPU engine memory "
                                 f"differ")
        res[key] = {"card_s": g["s"], "cpu_s": w["s"]}
    log(f"baselines parity: rmvmul n=4 unbounded and scalar at rings 128 "
        f"and 1024 (outputs and final engine memory), merge n={PARITY['n']} "
        f"unbounded (outputs, ANDs, table sha256 "
        f"{got['merge-unbounded']['digest'][:16]}): card == CPU (the CPU's "
        f"runs took {want['cpu_s']:.1f} s in their own process)")
    res["cpu_s"] = want["cpu_s"]
    return res


def _baseline_profile(dev) -> dict:
    """The GC and CKKS main jobs unbounded under torch.profiler: device
    busy share of the execute stage (a lower bound on the unprofiled
    run's) and device time by op."""
    from torch.profiler import ProfilerActivity, profile
    res = {}
    for name, s in (("gc", Session(JobSpec("merge", **MAIN_UNBOUNDED),
                                   device=dev)),
                    ("ckks", Session(JobSpec(**CKKS_UNBOUNDED),
                                     device=dev))):
        s.plan()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s.execute(real=True, check=True)
        wall_ms = s.timings["execute_s"] * 1e3
        evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
        busy_ms = sum(_dev_us(e) for e in evs) / 1e3
        log(f"baselines profile: {name} main unbounded, execute "
            f"{wall_ms:.1f} ms under the profiler, device busy "
            f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.3f} of it)")
        top = []
        for e in evs[:6]:
            log(f"  {_dev_us(e) / 1e3:10.2f} ms  {e.count:8d}x  "
                f"{e.key[:70]}")
            top.append([e.key[:60], _dev_us(e) / 1e3, e.count])
        res[name] = {"execute_ms": wall_ms, "busy_ms": busy_ms, "top": top}
    return res


def phase_baselines(dev, main_out: dict, planned: dict, cpu) -> dict:
    """The paper's baselines on the card, beside the planned main jobs;
    ``cpu`` is the async result of baseline_parity_cpu."""
    res = {"gc_main": _baseline_gc_main(dev, main_out, planned)}
    res["ckks_main"], ckks_planned = _baseline_ckks_turns(dev)
    res["policies"], gc_min = _baseline_policies(dev)
    res["scalar"] = _baseline_scalar(dev, gc_min, ckks_planned)
    res["memmap"] = _baseline_memmap(dev, gc_min, ckks_planned)
    res["parity"] = _baseline_parity(dev, cpu)
    res["profile"] = _baseline_profile(dev)
    return res


# ---------------------------------------------------------------------------
# the GC workloads: sort, ljoin, mvmul, binfclayer, the apps (passreuse and
# pir) and the plaintext oracle driver
# ---------------------------------------------------------------------------

#: the jobs' plan: budget 0.4 of the working set, 64 prefetch pages (at
#: least 8 + 64 frames, the prefetch buffer at most a quarter, as
#: resolve_plan_config clamps), lookahead 10000
GC_PLAN = dict(memory_budget=0.4, lookahead=10_000, prefetch_pages=64)
#: (workload, n, plan): the Fig. 8 sizes (benchmarks/fig8_swap.py:28-30)
#: and passreuse's (benchmarks/fig1213_apps.py:20), two-party on the
#: batched loop, cut so that the whole script stays under 1000 s (it took
#: 1000.4 s at full size): passreuse from 2048 to 1024, sort planned from
#: 1024 to 512, mvmul from 384 to 192; and, to make room for the workers
#: and the streaming phases, binfclayer from 2048 to 512, planned and
#: unbounded (its ops batch in neither plan; at 512 its plan still
#: swaps), and ljoin from 256 to 128 (its plan swaps 360/360 a party; the
#: streaming phase runs the same job from its file); sort
#: unbounded at its Fig. 8 size (planned there
#: it would make about 12 million AND calls a kernel) and planned with 8
#: prefetch pages: 64 ask for 72 frames, above its working set
GC_JOBS = [("ljoin", 128, GC_PLAN), ("mvmul", 192, GC_PLAN),
           ("binfclayer", 512, GC_PLAN),
           ("binfclayer", 512, dict(plan_mode="unbounded")),
           ("sort", 16384, dict(plan_mode="unbounded")),
           ("sort", 512, dict(GC_PLAN, prefetch_pages=8)),
           ("passreuse", 1024, GC_PLAN)]
#: pir at its Fig. 12/13 size, at the CKKS main job's width and plan
PIR_JOB = dict(workload="pir", n=256, memory_budget=0.4, lookahead=10_000,
               prefetch_pages=8, ckks_ring=1024, ckks_levels=2)
#: card against CPU at the port's test sizes (tests/_torch_gc_jobs.py):
#: (n, frames, prefetch pages)
GC_PARITY = {"sort": (64, 5, 1), "ljoin": (16, 5, 1), "mvmul": (32, 4, 1),
             "binfclayer": (128, 4, 1), "passreuse": (64, 5, 1)}
PIR_PARITY = dict(workload="pir", n=64, memory_budget=4, prefetch_pages=1)


def _parity_spec(wl: str) -> dict:
    n, frames, prefetch = GC_PARITY[wl]
    return dict(n=n, memory_budget=frames, prefetch_pages=prefetch)


def _memory_digest(s) -> str:
    return hashlib.sha256(s.engines[0].memory.cpu().numpy().tobytes()
                          ).hexdigest()


def _gc_parity_run(wl: str, device) -> dict:
    """One workload at its test size, two-party with the table digest and
    in the clear, on ``device``."""
    s = Session(JobSpec(wl, **_parity_spec(wl)), device=device)
    out = s.execute(real=True, check=True, digest=True)
    p = Session(JobSpec(wl, **_parity_spec(wl)), device=device)
    plain = p.execute(real=False, check=True)
    return {"outputs": out, "ands": [g.ands for g in s.gate_counts],
            "digest": s.table_digest, "plain_outputs": plain,
            "plain_memory": _memory_digest(p)}


def _gc_cpu_parity() -> dict:
    """The parity jobs with device="cpu", in a process of their own while
    the card runs the phase's jobs (one thread: the card's host work keeps
    its cores)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = {wl: _gc_parity_run(wl, "cpu") for wl in GC_PARITY}
    s = Session(JobSpec(**PIR_PARITY), device="cpu")
    res["pir"] = {"outputs": s.execute(check=True),
                  "memory": _memory_digest(s)}
    # the sort jobs in the clear, what the card's plaintext runs are held to
    res["plain_sort"] = {
        _job_key(wl, n, plan): Session(JobSpec(wl, n=n, **plan),
                                       device="cpu").execute(real=False)
        for wl, n, plan in GC_JOBS if wl == "sort"}
    res["cpu_s"] = time.perf_counter() - t0
    return res


def _job_key(wl: str, n: int, plan: dict) -> str:
    return f"{wl}-{n}-{plan.get('plan_mode', 'memory')}"


def _gc_job(wl: str, n: int, plan: dict, dev) -> tuple:
    s = Session(JobSpec(wl, n=n, **plan), device=dev)
    t0 = time.perf_counter()
    out = s.execute(real=True, check=True)
    return s, out, time.perf_counter() - t0


def _gc_workload_jobs(dev) -> tuple[dict, dict, dict]:
    """The phase's jobs on the card, two-party with the half-gates and NTT
    counters set to 0 just before the first and read just after the last
    (pir); every AND gate of both parties through the kernels, pir's
    transforms and products in the launches its instruction mix gives.
    Returns each job's metrics and the two counters."""
    ops.reset_counts()
    nops.reset_counts()
    jobs, total = {}, [0, 0]
    for wl, n, plan in GC_JOBS:
        s, out, seconds = _gc_job(wl, n, plan, dev)
        ands = [g.ands for g in s.gate_counts]
        total = [total[0] + ands[0], total[1] + ands[1]]
        mode = plan.get("plan_mode", "memory")
        if mode == "unbounded":
            _no_swaps(s)
        st = s.engine_stats
        t = s.timings["execute_s"]
        key = _job_key(wl, n, plan)
        jobs[key] = {
            "execute_s": t, "ands": ands[0], "ands_per_s": ands[0] / t,
            "all_s": seconds, "outputs": len(out),
            "num_frames": s.config.num_frames if s.config else None,
            "prefetch_pages": s.config.prefetch_pages if s.config else None,
            "swaps": [st[0].swap_ins, st[0].swap_outs],
            "frame_bytes": st[0].frame_bytes,
            "instructions": st[0].instructions,
            "batches": st[0].batches}
        j = jobs[key]
        log(f"gc workloads: {wl} n={n} {mode} ({j['num_frames']} frames, "
            f"{j['prefetch_pages']} prefetch), two-party, {len(out)} "
            f"outputs checked against the oracle: execute {t:.3f} s (all "
            f"{seconds:.3f}), {ands[0]} AND gates per party, "
            f"{ands[0] / t:.4e} AND gates/s; swaps in/out {j['swaps']} a "
            f"party; frame bytes {j['frame_bytes']}; {j['instructions']} "
            f"instructions, {j['batches']} batches")
    s, out, seconds, ntt = _ckks_checked_run(PIR_JOB, dev)
    gc = ops.counts()
    if (gc["garble_ands"], gc["eval_ands"]) != tuple(total) or not total[0]:
        raise AssertionError(f"ANDs through the kernels {gc} != gate counts "
                             f"{total}")
    st = s.engine_stats[0]
    t = s.timings["execute_s"]
    he = homomorphic_ops(s.op_counts)
    jobs[f"pir-{PIR_JOB['n']}-memory"] = {
        "execute_s": t, "keygen_s": s.timings["keygen_s"], "all_s": seconds,
        "he_ops": he, "he_ops_per_s": he / t, "outputs": len(out),
        "num_frames": s.config.num_frames,
        "swaps": [st.swap_ins, st.swap_outs], "frame_bytes": st.frame_bytes,
        "instructions": st.instructions, "launches": ntt["launches"]}
    log(f"gc workloads: pir n={PIR_JOB['n']} at ring 1024, levels 2 "
        f"({s.config.num_frames} frames), {len(out)} outputs checked "
        f"against the oracle (atol 2e-2): execute {t:.3f} s (keygen "
        f"{s.timings['keygen_s']:.3f}), {he} homomorphic ops, "
        f"{he / t:.1f} per second; swaps {st.swap_ins}/{st.swap_outs}; "
        f"launches {ntt['launches']}")
    log(f"  the phase's launches: garble_and {gc['garble_launches']}, "
        f"eval_and {gc['eval_launches']} (sizes "
        f"{sorted(gc['launch_sizes']['garble'].items())}); NTT "
        f"{ntt['launches']}")
    return jobs, gc, ntt


def _sort_ties(n: int, out: dict) -> int:
    """Check a plaintext sort's outputs against the oracle up to the order
    of records that share a key; returns the positions that differ.  The
    plaintext driver's SORT_LOCAL is a stable sort, which can order the
    records of one key otherwise than the oracle does, as the JAX
    package's gc-plaintext does (sort n=16384 holds one such pair:
    tests/test_torch_gc_workloads.py)."""
    want = get_workload("sort").oracle(n)
    if sorted(out) != sorted(want):
        raise AssertionError(f"sort n={n}: plaintext output tags != oracle")
    got = np.concatenate([out[k] for k in sorted(want)])
    exp = np.concatenate([want[k] for k in sorted(want)])
    key = np.uint64((1 << 32) - 1)
    if not (np.array_equal(got & key, exp & key)
            and np.array_equal(np.sort(got), np.sort(exp))):
        raise AssertionError(f"sort n={n}: plaintext outputs != oracle "
                             f"beyond the order of equal keys")
    return int((got != exp).sum())


def _gc_plaintext_jobs(dev) -> tuple[dict, dict]:
    """Every GC job of the phase through the plaintext oracle driver on the
    card; no AND gate is launched.  Each is checked against its oracle,
    but sort, whose outputs are returned to be held against the same job
    in the clear on the CPU (see ``_check_plain_sorts``)."""
    res, sorts = {}, {}
    ops.reset_counts()
    for wl, n, plan in GC_JOBS:
        s = Session(JobSpec(wl, n=n, **plan), device=dev)
        out = s.execute(real=False)
        key = _job_key(wl, n, plan)
        if wl == "sort":
            sorts[key] = (n, out)
        else:
            check_outputs(s.workload, n, out)
        t = s.timings["execute_s"]
        res[key] = {"execute_s": t,
                    "instructions": s.engine_stats[0].instructions}
        log(f"gc plaintext: {wl} n={n} {plan.get('plan_mode', 'memory')} "
            f"on the card, {len(out)} outputs"
            + (" (checked against the CPU's below)" if wl == "sort" else
               " checked against the oracle")
            + f": execute {t:.3f} s, {s.engine_stats[0].instructions} "
            f"instructions")
    if ops.counts()["garble_launches"]:
        raise AssertionError("the plaintext driver launched half gates")
    return res, sorts


def _check_plain_sorts(sorts: dict, cpu: dict, res: dict) -> None:
    """The card's plaintext sorts equal the CPU's bit for bit (the CPU's
    equal the JAX package's gc-plaintext, tests/test_torch_gc_workloads.py)
    and the oracle up to the order of records of one key."""
    for key, (n, out) in sorts.items():
        if not _same(out, cpu[key]):
            raise AssertionError(f"plaintext {key}: card and CPU differ")
        ties = res[key]["tie_positions"] = _sort_ties(n, out)
        log(f"gc plaintext: {key} on the card == on the CPU, bit for bit; "
            f"the oracle up to the order of equal keys ({ties} positions "
            f"differ)")


def _gc_card_parity(dev, cpu: dict) -> dict:
    """The card against the CPU process's runs at the test sizes."""
    res = {}
    for wl in GC_PARITY:
        t0 = time.perf_counter()
        card, want = _gc_parity_run(wl, dev), cpu[wl]
        if not (_same(card["outputs"], want["outputs"])
                and _same(card["plain_outputs"], want["plain_outputs"])):
            raise AssertionError(f"{wl}: card and CPU outputs differ")
        if card["ands"] != want["ands"] or card["ands"][0] != card["ands"][1]:
            raise AssertionError(f"{wl}: AND counts {card['ands']} != "
                                 f"{want['ands']}")
        if card["digest"] != want["digest"]:
            raise AssertionError(f"{wl}: garbled-table streams differ")
        if card["plain_memory"] != want["plain_memory"]:
            raise AssertionError(f"{wl}: plaintext engine memory differs")
        res[wl] = time.perf_counter() - t0
        log(f"gc parity: {wl} n={GC_PARITY[wl][0]} on the card == on the "
            f"CPU: {len(card['outputs'])} outputs, {card['ands'][0]} ANDs, "
            f"table sha256 {card['digest'][:16]}; plaintext outputs and "
            f"final engine memory (sha256 {card['plain_memory'][:16]})")
    s = Session(JobSpec(**PIR_PARITY), device=dev)
    out = s.execute(check=True)
    if not _same(out, cpu["pir"]["outputs"]) or \
            _memory_digest(s) != cpu["pir"]["memory"]:
        raise AssertionError("pir: card and CPU differ")
    log(f"gc parity: pir n={PIR_PARITY['n']} at ring 128 on the card == on "
        f"the CPU: {len(out)} outputs and the final engine memory bit for "
        f"bit")
    return res


def phase_gc_workloads(dev) -> tuple[dict, dict, dict]:
    """The rest of the GC workloads and the apps on the card, the
    plaintext driver, and card against CPU at the test sizes (the CPU runs
    in a process of its own meanwhile).  Returns the metrics and the half
    gates' and NTT counters of the jobs' run."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        cpu_runs = pool.apply_async(_gc_cpu_parity)
        jobs, gc, ntt = _gc_workload_jobs(dev)
        plain, sorts = _gc_plaintext_jobs(dev)
        cpu = cpu_runs.get()
    log(f"gc parity: the CPU runs took {cpu['cpu_s']:.1f} s (their own "
        f"process, one thread)")
    _check_plain_sorts(sorts, cpu["plain_sort"], plain)
    parity = _gc_card_parity(dev, cpu)
    return {"jobs": jobs, "plaintext": plain, "parity_card_s": parity,
            "parity_cpu_s": cpu["cpu_s"],
            "launches": {"garble_and": gc["garble_launches"],
                         "eval_and": gc["eval_launches"],
                         "ntt": ntt["launches"]}}, gc, ntt


# ---------------------------------------------------------------------------
# multi-worker jobs and the overlap backend (Fig. 10): four workers a party
# ---------------------------------------------------------------------------

#: Fig. 10's workers a party and plans (benchmarks/fig10_parallel.py:27-32,
#: src/repro/scenarios.py:45-49): a budget of 0.4 of every worker's own
#: working set, GC with lookahead 10000 and 16 prefetch pages, CKKS at ring
#: 1024, levels 2, lookahead 100 and 16 prefetch pages (each clamped to a
#: quarter of the budget, as resolve_plan_config does)
WORKERS = 4
W_GC_PLAN = dict(memory_budget=0.4, lookahead=10_000, prefetch_pages=16)
W_CKKS_PLAN = dict(memory_budget=0.4, lookahead=100, prefetch_pages=16,
                   ckks_ring=1024, ckks_levels=2)
W_CKKS_UNBOUNDED = dict(plan_mode="unbounded", ckks_ring=1024, ckks_levels=2)
UNBOUNDED = dict(plan_mode="unbounded")
W_LOOPS = ("batched", "overlap")
#: Fig. 10's merge n = 16384 unbounded, cut to 1024 so that the whole
#: script stays well inside its time limit on a slow host (at 16384 its
#: p = 4 run took 69.5 s); the fleet phase runs the same jobs as fleets
FIG10_N = 1024
#: (workload, n, plan, workers, loops): every job checked against its
#: oracle, each p = 4 job beside the p = 1 job of the same n and plan.
#: merge at FIG10_N unbounded on the batched loop; at Fig. 10's tiny
#: n = 2048 unbounded on both loops (91.6 s at n = 16384 on the overlap
#: loop); planned it is cut to FIG10_N (from Fig. 10's tiny 2048,
#: benchmarks/fig10_parallel.py:29, where its two runs took 52.6 s; at
#: 1024 the p = 1 plan still swaps 381/381) on the batched loop only (its
#: overlap run is the parity job's): NET directives and swap directives
#: are barriers to exec.batching, so the planned program batches almost
#: nothing and runs at the host's pace per AND call (the phase took 341 s
#: with it at n = 4096 on both loops); sort n = 8192 and mvmul n = 384
#: are cut for time
WORKER_JOBS = [
    ("merge", FIG10_N, UNBOUNDED, WORKERS, ("batched",)),
    ("merge", FIG10_N, UNBOUNDED, 1, ("batched",)),
    ("merge", FIG10_N, W_GC_PLAN, WORKERS, ("batched",)),
    ("merge", 2048, UNBOUNDED, WORKERS, W_LOOPS),
    ("merge", FIG10_N, W_GC_PLAN, 1, ("batched",)),
    ("merge", 2048, UNBOUNDED, 1, ("batched",))] + [
    (wl, n, plan, p, W_LOOPS if p > 1 else ("batched",))
    for wl, n in (("rsum", 256), ("rmvmul", 24))
    for plan in (W_CKKS_PLAN, W_CKKS_UNBOUNDED) for p in (WORKERS, 1)]
#: card against CPU: two-party merge n=64 at p = 2 (outputs, AND counts,
#: the table digest of each party link) and rsum n=32 at p = 4, ring 128
#: (outputs and every engine's final memory), on both loops
W_PARITY_GC = dict(workload="merge", n=64, num_workers=2, memory_budget=5,
                   prefetch_pages=1)
W_PARITY_CKKS = dict(workload="rsum", n=32, num_workers=4, memory_budget=3,
                     prefetch_pages=1)


def _worker_key(wl: str, n: int, plan: dict, p: int, loop: str) -> str:
    return f"{wl}-{n}-{plan.get('plan_mode', 'memory')}-p{p}-{loop}"


def _net_links(s) -> dict:
    """NET traffic per worker link (src -> dst rank within a party): the
    transport's messages and bytes, party links left out."""
    p = s.spec.num_workers
    return {f"{src}->{dst}": [t.messages, t.bytes] for (src, dst), t in
            sorted(aggregate_links(s.transport_stats).items())
            if src // p == dst // p}


def _worker_job(wl: str, n: int, plan: dict, p: int, loop: str, dev
                ) -> dict:
    """One job on the card, checked against its oracle: two-party for GC,
    every AND gate of both parties through the half-gates kernels (the
    counters are the phase's, so this checks the job's share); a CKKS
    job's transforms and products in the launches its instruction mix
    gives."""
    spec = dict(workload=wl, n=n, num_workers=p, exec_backend=loop, **plan)
    before = ops.counts()
    nbefore = nops.counts()["launches"]
    s = Session(JobSpec(**spec), device=dev)
    t0 = time.perf_counter()
    out = s.execute(check=True)
    seconds = time.perf_counter() - t0
    st = s.engine_stats
    t = s.timings["execute_s"]
    if plan.get("plan_mode") == "unbounded":
        _no_swaps(s)
    res = {"execute_s": t, "all_s": seconds, "outputs": len(out),
           "num_frames": [c.num_frames for c in s.configs] or None,
           "prefetch_pages": [c.prefetch_pages for c in s.configs] or None,
           "swaps": [[e.swap_ins, e.swap_outs] for e in st],
           "frame_bytes": [e.frame_bytes for e in st],
           "instructions": [e.instructions for e in st],
           "batched": [e.batched_instructions for e in st],
           "batches": [e.batches for e in st],
           "net_messages": [e.net_messages for e in st],
           "net_bytes": [[e.net_sent_bytes, e.net_recv_bytes] for e in st],
           "posted_recvs": [e.posted_recvs for e in st],
           "max_inflight_recvs": [e.max_inflight_recvs for e in st],
           "net_links": _net_links(s)}
    if s.protocol == "gc":
        c = ops.counts()
        ands = [g.ands for g in s.gate_counts]
        got = [c["garble_ands"] - before["garble_ands"],
               c["eval_ands"] - before["eval_ands"]]
        if got != ands or not ands[0]:
            raise AssertionError(f"{wl}: ANDs through the kernels {got} != "
                                 f"gate counts {ands}")
        res.update(ands=ands[0], ands_per_s=ands[0] / t,
                   garble_launches=c["garble_launches"]
                   - before["garble_launches"])
        rate = f"{ands[0]} AND gates a party, {ands[0] / t:.4e} AND gates/s"
    else:
        launches = {k: v - nbefore[k]
                    for k, v in nops.counts()["launches"].items()}
        want = expected_ntt_launches(s, plan["ckks_levels"])
        if launches != want or not want["ntt_mul"]:
            raise AssertionError(f"{wl}: NTT launches {launches} != {want}, "
                                 f"what the instruction mix gives")
        he = homomorphic_ops(s.op_counts)
        res.update(keygen_s=s.timings["keygen_s"], he_ops=he,
                   he_ops_per_s=he / t, ntt_launches=launches)
        rate = f"{he} homomorphic ops, {he / t:.1f} per second"
    log(f"workers: {wl} n={n} {plan.get('plan_mode', 'memory')} p={p} "
        f"{loop} (frames {res['num_frames']}, prefetch "
        f"{res['prefetch_pages']}), {len(out)} outputs checked against the "
        f"oracle: execute {t:.3f} s (all {seconds:.3f}), {rate}; "
        f"instructions {res['instructions']}, batched {res['batched']} in "
        f"{res['batches']} batches; NET messages {res['net_messages']}, "
        f"bytes sent/received {res['net_bytes']}, posted receives "
        f"{res['posted_recvs']} (at most {res['max_inflight_recvs']} in "
        f"flight); links {res['net_links']}; swaps {res['swaps']}; frame "
        f"bytes {res['frame_bytes']}")
    return res


def _worker_ratios(jobs: dict) -> dict:
    """planned / unbounded execute s where both ran, per (workload, n,
    workers, loop), and p = 4 / p = 1 for each (workload, n, plan)."""
    out = {}
    for key, j in jobs.items():
        wl, n, mode, p, loop = key.split("-")
        if mode == "memory":
            unb = jobs.get("-".join((wl, n, "unbounded", p, loop)))
            if unb:
                out[f"{wl}-{n}-{p}-{loop} planned/unbounded"] = \
                    j["execute_s"] / unb["execute_s"]
        if p != "p1":
            one = jobs.get("-".join((wl, n, mode, "p1", "batched")))
            if one:
                out[f"{wl}-{n}-{mode}-{loop} {p}/p1"] = \
                    j["execute_s"] / one["execute_s"]
    for k, v in out.items():
        log(f"workers: {k} = {v:.4f}")
    return out


def _worker_parity_runs(device) -> dict:
    """The parity jobs on ``device``: merge two-party with the table
    digest of each party link, rsum with every engine's final memory."""
    res = {}
    for loop in W_LOOPS:
        s = Session(JobSpec(exec_backend=loop, **W_PARITY_GC), device=device)
        out = s.execute(real=True, check=True, digest=True)
        res[f"merge-{loop}"] = {
            "outputs": out, "ands": [g.ands for g in s.gate_counts],
            "digests": {f"{a}->{b}": d
                        for (a, b), d in s.table_digests.items()}}
        c = Session(JobSpec(exec_backend=loop, **W_PARITY_CKKS),
                    device=device)
        res[f"rsum-{loop}"] = {
            "outputs": c.execute(check=True),
            "memory": [hashlib.sha256(e.memory.cpu().numpy().tobytes())
                       .hexdigest() for e in c.engines]}
    return res


def _workers_cpu_parity() -> dict:
    """The parity jobs with device="cpu", in a process of their own while
    the card runs the phase's jobs (one thread)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = _worker_parity_runs("cpu")
    res["cpu_s"] = time.perf_counter() - t0
    return res


def _workers_card_parity(dev, cpu: dict) -> None:
    """The card's parity runs against the CPU process's."""
    for key, got in _worker_parity_runs(dev).items():
        want = cpu[key]
        if not _same(got["outputs"], want["outputs"]):
            raise AssertionError(f"workers {key}: card and CPU outputs "
                                 f"differ")
        if key.startswith("merge"):
            if got["ands"] != want["ands"] or \
                    got["digests"] != want["digests"]:
                raise AssertionError(f"workers {key}: AND counts or party "
                                     f"links' table streams differ")
            short = {k: d[:16] for k, d in got["digests"].items()}
            log(f"workers parity: two-party merge n=64 p=2 {key[6:]} on "
                f"the card == on the CPU: {len(got['outputs'])} outputs, "
                f"{got['ands'][0]} ANDs, table sha256 per party link "
                f"{short}")
        else:
            if got["memory"] != want["memory"]:
                raise AssertionError(f"workers {key}: engine memory "
                                     f"differs")
            log(f"workers parity: rsum n=32 p=4 at ring 128 {key[5:]} on "
                f"the card == on the CPU: outputs and the 4 engines' final "
                f"memory bit for bit")


def phase_workers(dev) -> tuple[dict, dict, dict]:
    """Multi-worker jobs and the overlap backend on the card (four
    workers a party, NET_* directives over the worker links, a party
    link a worker pair), and card against CPU at the parity sizes (the
    CPU runs in a process of their own meanwhile).  Returns the metrics
    and the half gates' and NTT counters of the jobs' run, set to 0 just
    before the first job and read just after the last."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        cpu_runs = pool.apply_async(_workers_cpu_parity)
        ops.reset_counts()
        nops.reset_counts()
        jobs = {}
        for wl, n, plan, p, loops in WORKER_JOBS:
            for loop in loops:
                jobs[_worker_key(wl, n, plan, p, loop)] = _worker_job(
                    wl, n, plan, p, loop, dev)
        gc, ntt = ops.counts(), nops.counts()
        cpu = cpu_runs.get()
    if any(ntt["plain_calls"].values()):
        raise AssertionError(f"plain NTT versions ran: {ntt['plain_calls']}")
    log(f"workers: the phase's launches: garble_and "
        f"{gc['garble_launches']}, eval_and {gc['eval_launches']}; NTT "
        f"{ntt['launches']}; the CPU's parity runs took {cpu['cpu_s']:.1f} s "
        f"(their own process, one thread)")
    ratios = _worker_ratios(jobs)
    _workers_card_parity(dev, cpu)
    return {"jobs": jobs, "ratios": ratios, "parity_cpu_s": cpu["cpu_s"],
            "launches": {"garble_and": gc["garble_launches"],
                         "eval_and": gc["eval_launches"],
                         "ntt": ntt["launches"]}}, gc, ntt


# ---------------------------------------------------------------------------
# the fleet: saved plans, and one process a rank over localhost TCP
# ---------------------------------------------------------------------------

#: (name, ``plan`` arguments, ``fabric`` arguments, timeout s): the parity
#: phase's planned merge through a saved plan, as a garbler and an
#: evaluator process; GC main's unbounded job as a two-rank fleet (the
#: party link over TCP), cut to n = 4096 and held to the same job run in
#: process; Fig. 10's merge at four workers a party as an 8-rank fleet
#: and at one worker as a 2-rank fleet, at FIG10_N (the workers phase's
#: jobs of that n beside them); and rsum at four workers, ring 1024, as a
#: 4-rank fleet.  At n = 16384 the 8-rank fleet took 211 s (the
#: in-process run 53 s), at n = 2048 43.5 s; the two-rank fleet took 19 s
#: at n = 16384
FLEET_TCP = dict(n=4096, plan_mode="unbounded")
FLEET_JOBS = [
    ("saved-plan", ["--workload", "merge", "-n", str(PARITY["n"]),
                    "--budget", str(PARITY["memory_budget"]), "--lookahead",
                    str(PARITY["lookahead"]), "--prefetch",
                    str(PARITY["prefetch_pages"])], ["--real", "--digest"],
     120),
    ("gc-tcp", ["--workload", "merge", "-n", str(FLEET_TCP["n"])],
     ["--real"], 120),
    ("fig10-p4", ["--workload", "merge", "-n", str(FIG10_N), "--workers",
                  str(WORKERS)], ["--real"], 180),
    ("fig10-p1", ["--workload", "merge", "-n", str(FIG10_N)], ["--real"],
     120),
    ("rsum-p4", ["--workload", "rsum", "-n", "256", "--workers",
                 str(WORKERS), "--budget", "0.4", "--lookahead", "100",
                 "--prefetch", "16", "--ckks-ring", "1024", "--ckks-levels",
                 "2"], [], 120)]


def _tuplify(x):
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


def _fleet_counts(reports: list) -> tuple[dict, dict]:
    """The half gates' and the NTT counters summed over the ranks' own
    (each set to 0 just before its rank ran), in ``ops.counts()`` /
    ``nops.counts()`` form for kernel_record and ntt_record."""
    gc = {k: 0 for k in ("garble_launches", "eval_launches", "garble_ands",
                         "eval_ands")}
    gc["launch_sizes"] = {"garble": {}, "eval": {}}
    ntt = {k: dict.fromkeys(nops.KINDS, 0) for k in ("launches", "rows",
                                                     "plain_calls")}
    ntt["launch_sizes"] = {k: {} for k in nops.KINDS}
    ntt["mul_shapes"] = {}
    for rep in reports:
        kc = rep["kernel_counts"]
        for k in ("garble_launches", "eval_launches", "garble_ands",
                  "eval_ands"):
            gc[k] += kc["gc"][k]
        for src, dst in ((kc["gc"]["launch_sizes"], gc["launch_sizes"]),
                         (kc["ntt"]["launch_sizes"], ntt["launch_sizes"])):
            for kind, pairs in src.items():
                for m, k in pairs:
                    dst[kind][m] = dst[kind].get(m, 0) + k
        for key in ("launches", "rows", "plain_calls"):
            for kind, v in kc["ntt"][key].items():
                ntt[key][kind] += v
        for shape, k in kc["ntt"]["mul_shapes"]:
            shape = _tuplify(shape)
            ntt["mul_shapes"][shape] = ntt["mul_shapes"].get(shape, 0) + k
    return gc, ntt


def _fleet_job(name: str, plan: list, flags: list, timeout: int,
               tmp: str) -> dict:
    """``plan`` a job into a directory, then ``fabric`` it (one process a
    rank, each checked: on the card, every AND gate and NTT through the
    kernels and no plain version run), all through the port's CLI."""
    from repro_torch import __main__ as cli
    job = os.path.join(tmp, name)
    merged = os.path.join(tmp, f"{name}.json")
    t0 = time.perf_counter()
    if cli.main(["plan", *plan, "--out", job]) != 0:
        raise AssertionError(f"fleet {name}: plan failed")
    plan_s = time.perf_counter() - t0
    if cli.main(["fabric", job, "--check", "--json", merged, "--timeout",
                 str(timeout), *flags]) != 0:
        raise AssertionError(f"fleet {name}: fabric failed")
    with open(merged) as f:
        doc = json.load(f)
    ranks = sorted(doc["ranks"], key=lambda r: r["rank"])
    for r in ranks:
        kc = r["kernel_counts"]
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"fleet {name}: rank {r['rank']} ran on "
                                 f"{r['device']}")
        if any(kc["ntt"]["plain_calls"].values()):
            raise AssertionError(f"fleet {name}: rank {r['rank']} ran plain "
                                 f"NTT versions {kc['ntt']['plain_calls']}")
        if r["driver"] == "gc-2party":
            got = [kc["gc"]["garble_ands"], kc["gc"]["eval_ands"]]
            if got != r["and_gates"] or not sum(got):
                raise AssertionError(f"fleet {name}: rank {r['rank']}'s ANDs "
                                     f"through the kernels {got} != its gate "
                                     f"counts {r['and_gates']}")
        elif not kc["ntt"]["launches"]["ntt_mul"]:
            raise AssertionError(f"fleet {name}: rank {r['rank']} launched "
                                 f"no fused NTT kernel")
    ex = [r["timings"]["execute_s"] for r in ranks]
    res = {"ranks": len(ranks), "plan_s": plan_s,
           "fleet_s": doc["seconds"], "execute_s": ex,
           "connect_s": [r["timings"]["connect_s"] for r in ranks],
           "barrier_s": [r["timings"]["barrier_s"] for r in ranks],
           "max_memory_allocated": [r["max_memory_allocated"]
                                    for r in ranks],
           "and_gates": [r["and_gates"] for r in ranks],
           "links": {k: v for r in ranks for k, v in r["links"].items()},
           "digests": {k: v for r in ranks
                       for k, v in r["table_digests"].items()},
           "outputs": {int(k): np.asarray(v, dtype=np.uint64 if
                                          doc["driver"] != "ckks" else
                                          np.float64)
                       for k, v in doc["outputs"].items()},
           "reports": ranks}
    log(f"fleet: {name}, {len(ranks)} ranks ({doc['driver']}) on "
        f"{sorted({r['device'] for r in ranks})}, {len(res['outputs'])} "
        f"outputs checked against the oracle: plan {plan_s:.2f} s, fleet "
        f"{doc['seconds']:.2f} s wall; execute a rank "
        f"{[round(x, 3) for x in ex]} s, connect "
        f"{[round(x, 2) for x in res['connect_s']]} s, barrier "
        f"{[round(x, 3) for x in res['barrier_s']]} s; AND gates "
        f"{res['and_gates']}; max_memory_allocated a rank "
        f"{res['max_memory_allocated']}; links {res['links']}")
    return res


def phase_fleet(dev, parity_ref: dict, workers: dict
                ) -> tuple[dict, dict, dict]:
    """Saved plans and the fleet on the card, through the port's own CLI
    (``plan``, then ``fabric``: one ``run JOBDIR --worker K`` process a
    rank over localhost TCP), each job held to its in-process run of this
    call.  Returns the metrics and the half gates' and NTT counters summed
    over every rank's run (each rank's set to 0 just before it ran)."""
    import tempfile
    out = {}
    tcp_s, tcp_out, _, tcp_c = _gc_checked_run(FLEET_TCP, dev)
    with tempfile.TemporaryDirectory(prefix="mage_fleet_") as tmp:
        jobs = {name: _fleet_job(name, plan, flags, timeout, tmp)
                for name, plan, flags, timeout in FLEET_JOBS}
    gc, ntt = _fleet_counts([r for j in jobs.values() for r in j["reports"]])
    # 1. the saved plan, as two processes, equals the parity phase's run
    j = jobs["saved-plan"]
    if not _same(j["outputs"], parity_ref["outputs"]):
        raise AssertionError("fleet saved-plan: outputs != the in-process "
                             "card run's")
    if [j["and_gates"][0][0], j["and_gates"][1][1]] != parity_ref["ands"]:
        raise AssertionError(f"fleet saved-plan: AND counts "
                             f"{j['and_gates']} != {parity_ref['ands']}")
    if j["digests"] != {"0->1": parity_ref["digest"]}:
        raise AssertionError("fleet saved-plan: the garbler's table stream "
                             "differs from the in-process run's")
    log(f"fleet: saved-plan merge n={PARITY['n']} as two processes == the "
        f"parity phase's in-process card run: outputs, "
        f"{parity_ref['ands'][0]} ANDs, the garbler's table sha256 "
        f"{parity_ref['digest'][:16]}")
    out["saved_plan"] = {k: j[k] for k in ("fleet_s", "execute_s",
                                           "max_memory_allocated")}
    # 2. two-party GC over TCP equals the same job in process
    j = jobs["gc-tcp"]
    if not _same(j["outputs"], tcp_out):
        raise AssertionError("fleet gc-tcp: outputs != the in-process run's")
    ands = j["and_gates"][0][0]
    launches = j["reports"][0]["kernel_counts"]["gc"]["garble_launches"]
    if ands != tcp_s.gate_counts[0].ands or \
            launches != tcp_c["garble_launches"]:
        raise AssertionError(f"fleet gc-tcp: {ands} ANDs in {launches} "
                             f"launches != the in-process run's "
                             f"{tcp_s.gate_counts[0].ands} in "
                             f"{tcp_c['garble_launches']}")
    link = j["links"]["0->1"]
    t = max(j["execute_s"])
    t_in = tcp_s.timings["execute_s"]
    out["gc_tcp"] = {"n": FLEET_TCP["n"], "execute_s": j["execute_s"],
                     "fleet_s": j["fleet_s"], "party_link": link,
                     "party_link_bytes_per_s": link[1] / t,
                     "in_process_execute_s": t_in,
                     "max_memory_allocated": j["max_memory_allocated"]}
    log(f"fleet: gc-tcp merge n={FLEET_TCP['n']} unbounded as two "
        f"processes: execute {t:.3f} s (in process {t_in:.3f} s, same "
        f"call); party link {link[0]} messages, {link[1]} bytes, "
        f"{link[1] / t:.4e} bytes/s; {ands} ANDs a party in {launches} "
        f"launches, as in process")
    wj = workers["jobs"]
    # 3. Fig. 10's merge at p = 4 and p = 1, one process a rank, beside
    # the same jobs in process
    f4, f1 = jobs["fig10-p4"], jobs["fig10-p1"]
    if not _same(f4["outputs"], f1["outputs"]):
        raise AssertionError("fleet fig10: p = 4 and p = 1 outputs differ")
    i4, i1 = (wj[f"merge-{FIG10_N}-unbounded-p{p}-batched"] for p in (4, 1))
    for j, inproc, p in ((f4, i4, WORKERS), (f1, i1, 1)):
        g_ands = sum(a[0] for a in j["and_gates"])
        if g_ands != inproc["ands"]:
            raise AssertionError(f"fleet fig10 p={p}: {g_ands} ANDs a party "
                                 f"!= the in-process run's {inproc['ands']}")
    t4, t1 = max(f4["execute_s"]), max(f1["execute_s"])
    out["fig10"] = {
        "n": FIG10_N, "p4_execute_s": f4["execute_s"],
        "p1_execute_s": f1["execute_s"], "p4_fleet_s": f4["fleet_s"],
        "p1_fleet_s": f1["fleet_s"],
        "max_memory_allocated": f4["max_memory_allocated"],
        "in_process_p4_s": i4["execute_s"], "in_process_p1_s":
        i1["execute_s"], "fleet_p4_over_p1": t4 / t1,
        "in_process_p4_over_p1": i4["execute_s"] / i1["execute_s"],
        "fleet_over_in_process": [t4 / i4["execute_s"],
                                  t1 / i1["execute_s"]]}
    log(f"fleet: fig10 merge n={FIG10_N} unbounded, p={WORKERS} as "
        f"{f4['ranks']} processes and p=1 as {f1['ranks']}: execute {t4:.3f}"
        f" / {t1:.3f} s (slowest rank); in process, same call: "
        f"{i4['execute_s']:.3f} / {i1['execute_s']:.3f} s; p4 / p1 as a "
        f"fleet {t4 / t1:.4f}, in process "
        f"{i4['execute_s'] / i1['execute_s']:.4f}")
    j = jobs["rsum-p4"]
    inproc = wj["rsum-256-memory-p4-batched"]
    got = {k: sum(r["kernel_counts"]["ntt"]["launches"][k]
                  for r in j["reports"]) for k in nops.KINDS}
    if got != inproc["ntt_launches"]:
        raise AssertionError(f"fleet rsum-p4: NTT launches {got} != the "
                             f"in-process run's {inproc['ntt_launches']}")
    out["rsum_p4"] = {"execute_s": j["execute_s"], "fleet_s": j["fleet_s"],
                      "ntt_launches": got,
                      "in_process_execute_s": inproc["execute_s"],
                      "max_memory_allocated": j["max_memory_allocated"]}
    log(f"fleet: rsum n=256 p={WORKERS} ring 1024 as {j['ranks']} processes: "
        f"execute {max(j['execute_s']):.3f} s (in process "
        f"{inproc['execute_s']:.3f} s), NTT launches {got} == in process")
    out["launches"] = {"garble_and": gc["garble_launches"],
                       "eval_and": gc["eval_launches"],
                       "ntt": ntt["launches"]}
    log(f"fleet: the phase's launches over every rank: garble_and "
        f"{gc['garble_launches']}, eval_and {gc['eval_launches']}; NTT "
        f"{ntt['launches']}")
    return out, gc, ntt


# ---------------------------------------------------------------------------
# the streaming planner and executor: plans made out of core, run from files
# ---------------------------------------------------------------------------

#: Fig. 8's streaming case (benchmarks/fig8_swap.py:35-38): merge past the
#: planner's cap, planned out of core at Fig. 8's budget; host work only
STREAM_CASE = dict(n=131072, memory_budget=0.4, lookahead=10_000,
                   prefetch_pages=64)
#: the reference's planner memory cap (benchmarks/common.py), which
#: Fig. 8's streaming case's memory program must exceed
PLANNER_CAP_MB = 8.0
#: the GC workload streamed: the gc workloads phase's ljoin, cut from its
#: Fig. 8 size (256, benchmarks/fig8_swap.py:30) to 128 there and here,
#: so that the whole script stays under its time limit
STREAM_LJOIN = ("ljoin", 128, GC_PLAN)


def streaming_case() -> dict:
    """Fig. 8's streaming case on the host (``main`` starts it in a
    process of its own at the top and the streaming phase collects it):
    the vectorized trace of merge n=131072 written as a file, its working
    set from the file, then ``plan_streaming`` at 0.4 of it with 64
    prefetch pages, file to file under tracemalloc; then the DSL trace of
    the same n planned in memory, whose records the file must hold.  All
    files live in a temporary directory, removed at the end."""
    import tempfile
    torch.set_num_threads(1)
    spec = JobSpec("merge", **STREAM_CASE)
    res = {"n": spec.n}
    with tempfile.TemporaryDirectory(prefix="mage_stream_") as tmp:
        t0 = time.perf_counter()
        vpf = fast_trace.write_merge_program(
            os.path.join(tmp, "virtual.bc"), spec.n)
        res["trace_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ws = working_set_pages_stream(vpf)
        res["working_set_s"] = time.perf_counter() - t0
        cfg = resolve_plan_config(spec, ws)
        t0 = time.perf_counter()
        mem, rep = plan_streaming(vpf, cfg, workdir=tmp, track_memory=True)
        res.update(
            plan_s=time.perf_counter() - t0, annotate_s=rep.annotate_s,
            replacement_s=rep.replacement_s, scheduling_s=rep.scheduling_s,
            peak_mem_bytes=rep.peak_mem_bytes, working_set=ws,
            num_frames=cfg.num_frames, prefetch_pages=cfg.prefetch_pages,
            virtual_records=len(vpf),
            virtual_bytes=os.path.getsize(vpf.path),
            program_bytes=os.path.getsize(mem.path), instructions=len(mem),
            swaps=[rep.replacement.swap_ins, rep.replacement.swap_outs],
            digest=file_digest(mem))
        t0 = time.perf_counter()
        prog = get_workload("merge").trace(spec.n, 1)[0]
        res["dsl_digest"] = program_digest(plan(prog, cfg)[0])
        res["dsl_s"] = time.perf_counter() - t0
    return res


def _streamed(wl: str, job: dict, dev, digest: bool = False) -> dict:
    """One GC job planned out of core (its memory programs are files in
    the Session's temporary directory, removed at its close) and run from
    its files, two-party on the batched loop, checked against the
    oracle."""
    spec = JobSpec(wl, **job, plan_mode="streaming", track_plan_memory=True)
    with Session(spec, device=dev) as s:
        t0 = time.perf_counter()
        out = s.execute(real=True, check=True, digest=digest)
        seconds = time.perf_counter() - t0
        planned = s.plan()
        if not all(isinstance(p, ProgramFile) for p in planned):
            raise AssertionError(f"{wl} streamed: the plan is not files")
        st = s.engine_stats
        res = {"outputs": out, "ands": [g.ands for g in s.gate_counts],
               "digest": s.table_digest, "swaps": list(_swaps(s)[:2]),
               "party_swaps": [st[0].swap_ins, st[0].swap_outs],
               "plan_digest": file_digest(planned[0]), "s": seconds,
               "execute_s": s.timings["execute_s"],
               "plan_s": s.timings["plan_s"],
               "annotate_s": s.timings["annotate_s"],
               "peak_mem_bytes": s.timings["peak_mem_bytes"],
               "program_bytes": os.path.getsize(planned[0].path),
               "instructions": len(planned[0])}
        tmp = s._tmpdir
    if tmp is None or os.path.exists(tmp):
        raise AssertionError(f"{wl} streamed: the plan's directory stayed")
    log(f"streaming: {wl} n={job['n']} on the batched loop from its "
        f"memory-program file ({res['instructions']} records, "
        f"{res['program_bytes']} bytes), two-party, checked against the "
        f"oracle: {seconds:.2f} s (plan {res['plan_s']:.3f}, annotate "
        f"{res['annotate_s']:.3f}, execute {res['execute_s']:.3f}); planner "
        f"peak {res['peak_mem_bytes']} bytes; {res['ands'][0]} ANDs; swaps "
        f"in/out {res['swaps']}")
    return res


def _held_to(got: dict, want: dict, what: str, keys) -> None:
    if not _same(got["outputs"], want["outputs"]):
        raise AssertionError(f"streaming {what}: outputs differ")
    for k in keys:
        if got[k] != want[k]:
            raise AssertionError(f"streaming {what}: {k} {got[k]} != "
                                 f"{want[k]}")


def phase_streaming(dev, parity_ref: dict, ckks_ref: tuple, gc_ref: dict,
                    main_digest: int, case) -> tuple[dict, dict, dict]:
    """Plans made out of core and run from their files on the card, each
    held to its memory-mode run of this call: the parity merge and the
    sync-swap job on the batched loop (plan records, outputs, ANDs, swaps,
    and the parity merge's table digest: the parity phase's card runs),
    the CKKS main job (its swaps, outputs bit for bit and NTT launches),
    ljoin at its Fig. 8 size (the gc workloads phase's ANDs and swaps);
    GC main's plan made out of core (the records the main phase ran); and
    Fig. 8's streaming case from the process ``case`` (its planner
    checks).  The half gates' counters are set to 0 just before the first
    streamed run and read after the last GC run, the NTT counters around
    the CKKS run; every AND gate and NTT goes through the kernels.
    Returns the metrics and both counts."""
    out = {}
    ands = [0, 0]
    ops.reset_counts()
    for name, job, want in (("parity", PARITY, parity_ref),
                            ("sync swaps", SYNC_SWAPS, parity_ref["sync"])):
        got = _streamed("merge", job, dev, digest=True)
        keys = ["plan_digest", "ands", "swaps"] + \
            (["digest"] if "digest" in want else [])
        _held_to(got, want, name, keys)
        ands = [ands[0] + got["ands"][0], ands[1] + got["ands"][1]]
        out[name] = {k: got[k] for k in (
            "s", "execute_s", "plan_s", "annotate_s", "peak_mem_bytes",
            "program_bytes", "swaps")}
        log(f"streaming: {name} merge n={job['n']} streamed == its memory "
            f"plan (records digest {want['plan_digest']:#x}) and the parity "
            f"phase's card run: outputs, {want['ands'][0]} ANDs, swaps "
            f"{want['swaps']}"
            + (f", the garbler's table digest {want['digest'][:16]}"
               if "digest" in want else ""))
    wl, n, gplan = STREAM_LJOIN
    got = _streamed(wl, dict(n=n, **gplan), dev)
    ref = gc_ref[f"{wl}-{n}-memory"]
    if got["ands"][0] != ref["ands"] or got["party_swaps"] != ref["swaps"]:
        raise AssertionError(f"streaming {wl}: ANDs {got['ands'][0]}, swaps "
                             f"{got['party_swaps']} != the gc workloads "
                             f"phase's {ref['ands']}, {ref['swaps']}")
    ands = [ands[0] + got["ands"][0], ands[1] + got["ands"][1]]
    out[f"{wl}-{n}"] = {k: got[k] for k in (
        "s", "execute_s", "plan_s", "annotate_s", "peak_mem_bytes",
        "program_bytes", "swaps")}
    out[f"{wl}-{n}"]["memory_mode_execute_s"] = ref["execute_s"]
    gc = ops.counts()
    if [gc["garble_ands"], gc["eval_ands"]] != ands or not ands[0]:
        raise AssertionError(f"ANDs through the kernels {gc} != gate counts "
                             f"{ands}")
    # the CKKS main job from its file: the ckks main phase's run
    ckks_counts, ckks_out = ckks_ref
    spec = dict(CKKS_MAIN, plan_mode="streaming", track_plan_memory=True)
    s, cout, seconds, ntt = _ckks_checked_run(spec, dev)
    try:
        rep = s.plan_reports[0].replacement
        st = s.engine_stats[0]
        swaps = (st.swap_ins, st.swap_outs)
        if (rep.swap_ins, rep.swap_outs) != CKKS_MAIN_SWAPS or \
                swaps != CKKS_MAIN_SWAPS:
            raise AssertionError(f"streaming ckks: swaps {swaps} != "
                                 f"{CKKS_MAIN_SWAPS}")
        if not isinstance(s.plan()[0], ProgramFile):
            raise AssertionError("streaming ckks: the plan is not a file")
        if not _same(cout, ckks_out):
            raise AssertionError("streaming ckks: outputs differ from the "
                                 "ckks main phase's")
        if ntt["launches"] != ckks_counts["launches"]:
            raise AssertionError(f"streaming ckks: launches "
                                 f"{ntt['launches']} != the ckks main "
                                 f"phase's {ckks_counts['launches']}")
        t = s.timings
        out["ckks"] = {"s": seconds, "execute_s": t["execute_s"],
                       "plan_s": t["plan_s"], "annotate_s": t["annotate_s"],
                       "peak_mem_bytes": t["peak_mem_bytes"],
                       "program_bytes": os.path.getsize(s.plan()[0].path),
                       "swaps": list(swaps), "launches": ntt["launches"]}
    finally:
        s.close()
    log(f"streaming: ckks rmvmul n={CKKS_MAIN['n']} at ring 1024 from its "
        f"file: {len(cout)} outputs bit for bit the ckks main phase's, swaps "
        f"{swaps}, launches {ntt['launches']}; {seconds:.2f} s (plan "
        f"{t['plan_s']:.3f}, execute {t['execute_s']:.3f}); planner peak "
        f"{t['peak_mem_bytes']} bytes, program "
        f"{out['ckks']['program_bytes']} bytes")
    # GC main's plan out of core: the records the main phase ran
    spec = JobSpec("merge", **MAIN, plan_mode="streaming",
                   track_plan_memory=True)
    with Session(spec, device=dev) as s:
        t0 = time.perf_counter()
        mem = s.plan()[0]
        seconds = time.perf_counter() - t0
        d = file_digest(mem)
        t = s.timings
        out["gc_main_plan"] = {
            "s": seconds, "trace_s": t["trace_s"], "plan_s": t["plan_s"],
            "annotate_s": t["annotate_s"],
            "peak_mem_bytes": t["peak_mem_bytes"],
            "program_bytes": os.path.getsize(mem.path),
            "instructions": len(mem)}
    if d != main_digest:
        raise AssertionError(f"streaming gc main: plan digest {d:#x} != the "
                             f"main phase's {main_digest:#x}")
    g = out["gc_main_plan"]
    log(f"streaming: gc main merge n={MAIN['n']} planned out of core == the "
        f"plan the main phase ran (digest {d:#x}, {g['instructions']} "
        f"records, {g['program_bytes']} bytes): trace {g['trace_s']:.3f} s, "
        f"plan {g['plan_s']:.3f} s under tracemalloc (annotate "
        f"{g['annotate_s']:.3f}), planner peak {g['peak_mem_bytes']} bytes")
    # Fig. 8's streaming case, planned in its own process meanwhile
    c = case.get()
    cap = PLANNER_CAP_MB * 2**20
    if not c["program_bytes"] > cap:
        raise AssertionError(f"streaming case: program {c['program_bytes']} "
                             f"bytes within the {PLANNER_CAP_MB} MiB cap")
    if not c["peak_mem_bytes"] < c["program_bytes"] / 2:
        raise AssertionError(f"streaming case: planner peak "
                             f"{c['peak_mem_bytes']} not under half the "
                             f"program's {c['program_bytes']} bytes")
    if c["digest"] != c["dsl_digest"]:
        raise AssertionError("streaming case: the file's records != the "
                             "in-memory plan of the DSL trace")
    out["case"] = c
    log(f"streaming: Fig. 8's case merge n={c['n']} planned out of core in "
        f"its own process: virtual {c['virtual_records']} records "
        f"({c['virtual_bytes']} bytes, vectorized trace {c['trace_s']:.3f} "
        f"s), working set {c['working_set']} pages, {c['num_frames']} "
        f"frames ({c['prefetch_pages']} prefetch); memory program "
        f"{c['instructions']} records, {c['program_bytes']} bytes (> "
        f"{PLANNER_CAP_MB} MiB cap); plan {c['plan_s']:.3f} s under "
        f"tracemalloc (annotate {c['annotate_s']:.3f}, replacement "
        f"{c['replacement_s']:.3f}, scheduling {c['scheduling_s']:.3f}); "
        f"planner peak {c['peak_mem_bytes']} bytes (< half the program); "
        f"swaps {c['swaps']}; == the DSL trace's in-memory plan "
        f"({c['dsl_s']:.3f} s)")
    out["launches"] = {"garble_and": gc["garble_launches"],
                       "eval_and": gc["eval_launches"],
                       "ntt": ntt["launches"]}
    return out, gc, ntt


# ---------------------------------------------------------------------------
# the n-party Shamir protocol: three engine loops, card against CPU, and
# fig_nparty's predicted and measured NET stalls
# ---------------------------------------------------------------------------

#: (workload, n, parties): fig_nparty's FULL cases (benchmarks/fig_nparty.py,
#: shamir_stats n=2048 at 3 parties and n=2560 at 5) and shamir_cmp at its
#: default n (the Fermat zero test: about 120 dependent multiplications)
SHAMIR_JOBS = [("shamir_stats", 2048, 3), ("shamir_stats", 2560, 5),
               ("shamir_cmp", 1024, 3)]
SHAMIR_LOOPS = ("scalar", "batched", "overlap")
#: every job planned at half its working set, as fig_nparty plans it
SHAMIR_PLAN = dict(memory_budget=0.5)
#: fig_nparty's WAN: 11 ms one way (Oregon-class), 250 MB/s a flow
LAT_OREGON = 0.011
FLOW_BW = 250e6
#: fig_nparty's per-instruction cost for the predicted stall (s)
NPARTY_COST_S = 5e-8


def _shamir_key(wl: str, n: int, p: int) -> str:
    return f"{wl}-{n}-p{p}"


def _shamir_run(wl: str, n: int, p: int, loop: str, device) -> dict:
    """One Shamir job planned at SHAMIR_PLAN, checked against its oracle:
    outputs, NET traffic per worker link, every rank's final engine
    memory (sha256 of its bytes) and the engine counters."""
    s = Session(JobSpec(wl, n=n, num_workers=p, exec_backend=loop,
                        **SHAMIR_PLAN), device=device)
    t0 = time.perf_counter()
    out = s.execute(check=True)
    seconds = time.perf_counter() - t0
    st = s.engine_stats
    return {"outputs": out, "links": _net_links(s),
            "memory": [hashlib.sha256(e.memory.cpu().numpy().tobytes())
                       .hexdigest() for e in s.engines],
            "execute_s": s.timings["execute_s"], "all_s": seconds,
            "num_frames": [c.num_frames for c in s.configs],
            "swaps": [[e.swap_ins, e.swap_outs] for e in st],
            "instructions": [e.instructions for e in st],
            "batched": [e.batched_instructions for e in st],
            "net_messages": [e.net_messages for e in st],
            "posted_recvs": [e.posted_recvs for e in st]}


def shamir_cpu() -> dict:
    """The Shamir jobs on the scalar loop with device="cpu", in a process
    of its own while the card runs them (one thread)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = {_shamir_key(wl, n, p): _shamir_run(wl, n, p, "scalar", "cpu")
           for wl, n, p in SHAMIR_JOBS}
    res["cpu_s"] = time.perf_counter() - t0
    return res


def _nparty_predicted(n: int, p: int, dev) -> dict:
    """fig_nparty's planner section: the simulator's NET stall, in order
    against overlap, on the memory program the engine runs (worker 0 of
    shamir_stats planned at 0.5).  Model seconds."""
    with Session(JobSpec("shamir_stats", n=n, num_workers=p,
                         **SHAMIR_PLAN), device=dev) as s:
        prog = s.plan()[0]
    page_bytes = prog.page_slots * SLOT_BYTES["shamir"]
    kw = dict(net_latency_s=LAT_OREGON, net_bandwidth=FLOW_BW)
    ino = simulate_memory_program(prog, lambda i: NPARTY_COST_S, page_bytes,
                                  **kw)
    ovl = simulate_memory_program(prog, lambda i: NPARTY_COST_S, page_bytes,
                                  net_mode="overlap", **kw)
    net = sum(i.op in (Op.NET_SEND, Op.NET_RECV) for i in prog.instrs)
    swaps = sum(i.op in SWAP_DIRECTIVES for i in prog.instrs)
    cut = ino.net_stall / max(ovl.net_stall, 1e-12)
    log(f"shamir: fig_nparty predicted ({p} parties, n={n}): "
        f"{len(prog.instrs)} instructions, {net} NET directives, {swaps} "
        f"swap directives under a 0.5 budget; model NET stall "
        f"{ino.net_stall * 1e3:.1f} ms in order, {ovl.net_stall * 1e3:.1f} "
        f"ms overlapped ({cut:.2f}x cut, {ino.net_msgs} exchanges)")
    return {"instructions": len(prog.instrs), "net_directives": net,
            "swap_directives": swaps,
            "predicted_net_stall_inorder_s": ino.net_stall,
            "predicted_net_stall_overlap_s": ovl.net_stall,
            "predicted_stall_cut": cut, "net_exchanges": ino.net_msgs}


def _nparty_measured(n: int, p: int, dev) -> dict:
    """fig_nparty's measured section: shamir_stats unbounded over shaped
    links (LAT_OREGON one way, FLOW_BW a flow) on the card, the scalar
    loop against the overlap loop, each after an untimed warm-up run.
    Identical outputs and total bytes are required; the speedup is
    recorded, not gated (the reference's own 1.5x gate at 3 parties is a
    host-speed claim)."""
    fab = FabricSpec(latency_s=LAT_OREGON, bandwidth=FLOW_BW)
    kw = dict(num_workers=p, transport="shaped", fabric=fab, warmup=True,
              check=True, device=dev)
    ino = measure_traffic("shamir_stats", n, exec_backend="scalar", **kw)
    ovl = measure_traffic("shamir_stats", n, exec_backend="overlap", **kw)
    if not _same(ino.outputs, ovl.outputs):
        raise AssertionError(f"shamir: overlap outputs != in-order at "
                             f"{p} parties")
    if ino.total_bytes != ovl.total_bytes:
        raise AssertionError(f"shamir: bytes over the fabric differ: "
                             f"{ino.total_bytes} != {ovl.total_bytes}")
    speedup = ino.seconds / ovl.seconds
    log(f"shamir: fig_nparty measured ({p} parties, n={n}, shaped "
        f"{LAT_OREGON * 1e3:.0f} ms): in order {ino.seconds:.3f} s, overlap "
        f"{ovl.seconds:.3f} s ({speedup:.2f}x), {ino.total_bytes} bytes "
        f"over {len(ino.links)} links in {ino.total_messages} messages, "
        f"identical outputs")
    return {"inorder_s": ino.seconds, "overlap_s": ovl.seconds,
            "speedup": speedup, "total_bytes": ino.total_bytes,
            "messages": ino.total_messages, "links": len(ino.links)}


def phase_shamir(dev) -> dict:
    """The n-party Shamir jobs on the card, each on the scalar, batched
    and overlap loops and checked against its oracle: every loop's
    outputs and NET messages and bytes per worker link equal the scalar
    loop's, and every rank's final engine memory equals the CPU's (the
    same jobs run by shamir_cpu in a process of their own meanwhile), bit
    for bit; then fig_nparty's predicted and measured sections at its
    FULL cases.  No kernel lies on this path: the field ops are PyTorch
    tensor ops on the card."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu = pool.apply_async(shamir_cpu)
        return _shamir_on_card(dev, cpu)


def _shamir_on_card(dev, cpu) -> dict:
    jobs = {}
    for wl, n, p in SHAMIR_JOBS:
        key = _shamir_key(wl, n, p)
        runs = {loop: _shamir_run(wl, n, p, loop, dev)
                for loop in SHAMIR_LOOPS}
        base = runs["scalar"]
        for loop, r in runs.items():
            if not _same(r["outputs"], base["outputs"]) or \
                    r["links"] != base["links"]:
                raise AssertionError(f"shamir {key}: the {loop} loop's "
                                     f"outputs or NET links differ")
            log(f"shamir: {wl} n={n} at {p} parties, {loop} (frames "
                f"{r['num_frames']}), {len(r['outputs'])} outputs checked "
                f"against the oracle: execute {r['execute_s']:.3f} s (all "
                f"{r['all_s']:.3f}); instructions {r['instructions']}, "
                f"batched {r['batched']}; swaps {r['swaps']}; NET messages "
                f"{r['net_messages']}, posted receives {r['posted_recvs']}; "
                f"links {r['links']}")
        jobs[key] = {loop: {k: v for k, v in r.items()
                            if k not in ("outputs", "memory")}
                     for loop, r in runs.items()}
        jobs[key]["runs"] = runs
    cpu = cpu.get()
    for key, job in jobs.items():
        want = cpu[key]
        for loop, r in job.pop("runs").items():
            if not _same(r["outputs"], want["outputs"]) or \
                    r["memory"] != want["memory"] or \
                    r["links"] != want["links"]:
                raise AssertionError(f"shamir {key} {loop}: card != CPU "
                                     f"(outputs, engine memory or links)")
        log(f"shamir parity: {key} on the card's three loops == on the CPU: "
            f"outputs, NET links and every rank's final engine memory "
            f"({len(want['memory'])} engines, bit for bit)")
    nparty = {}
    for n, p in ((2048, 3), (2560, 5)):
        nparty[f"p{p}"] = {"n": n, **_nparty_predicted(n, p, dev),
                           **_nparty_measured(n, p, dev)}
    return {"jobs": jobs, "nparty": nparty, "cpu_s": cpu["cpu_s"]}


# ---------------------------------------------------------------------------
# bench: the §8.2 scenarios through the timing simulator (host work)
# ---------------------------------------------------------------------------

#: the array and the scalar simulator cores, field for field, on these
#: cases (the reference's tiny bench cases)
BENCH_CORE_CASES = (("merge", 2048), ("rsum", 128))


def _bench_cores_equal(name: str, n: int) -> None:
    with Session(scenario_spec(name, n, budget_frac=0.4)) as s:
        got = [s.simulate(cost_fn(s.protocol), model=STORAGE,
                          os_page_bytes=OS_PAGE_BYTES, core=core)
               for core in ("array", "scalar")]
    for a, b in zip(*got):
        for f in ("unbounded", "os", "mage"):
            if dataclasses.asdict(getattr(a, f)) != \
                    dataclasses.asdict(getattr(b, f)):
                raise AssertionError(f"bench: {name} n={n} {f}: array "
                                     f"core != scalar core")


def bench_case() -> dict:
    """The bench phase's host work, in a process of its own (``main``
    starts it after the build, the bench phase collects it; one thread):
    ``run_bench`` over the ten Fig. 8 cases at budget 0.4 with its
    MAGE-beats-OS check, the tiny streaming case (merge 4096 planned out
    of core), the array cores against the scalar ones on
    BENCH_CORE_CASES, and ``Session.simulate`` of GC main's own spec.
    The Sessions take their default device, the card, which simulation
    never touches.  What run_bench prints comes back as text."""
    import contextlib
    import io
    torch.set_num_threads(1)
    res = {}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        t0 = time.perf_counter()
        res["rows"] = run_bench(BENCH_CASES, budget_frac=0.4, check=True)
        res["bench_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["streaming"] = run_bench([], budget_frac=0.4, check=True,
                                     streaming_case=TINY_STREAMING_CASE)[0]
        res["streaming_s"] = time.perf_counter() - t0
    res["text"] = text.getvalue()
    t0 = time.perf_counter()
    for name, n in BENCH_CORE_CASES:
        _bench_cores_equal(name, n)
    res["cores_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with Session(JobSpec("merge", **MAIN)) as s:
        (w,) = s.simulate(cost_fn("gc"), model=STORAGE,
                          os_page_bytes=OS_PAGE_BYTES)
        res["gc_main"] = {
            "unbounded_s": w.unbounded.total, "os_s": w.os.total,
            "mage_s": w.mage.total, "plan_s": s.timings["plan_s"],
            "num_frames": w.config.num_frames,
            "swaps": [w.report.replacement.swap_ins,
                      w.report.replacement.swap_outs],
            "mage_stall_s": w.mage.stall, "instructions": w.instructions}
    res["gc_main_s"] = time.perf_counter() - t0
    return res


def phase_bench(case, gc_main_measured: dict | None) -> dict:
    """Collect the bench process ``case``: its rows (model seconds of the
    STORAGE calibration, the same on every host), and GC main's simulated
    MAGE / unbounded beside the baselines phase's measured planned /
    unbounded execute time on the card (``gc_main_measured``; None where
    that phase did not run)."""
    res = case.get()
    for line in res.pop("text").splitlines():
        log(line)
    rows = res["rows"]
    if len(rows) != len(BENCH_CASES):
        raise AssertionError(f"bench: {len(rows)} rows for "
                             f"{len(BENCH_CASES)} cases")
    g = res["gc_main"]
    sim_ratio = g["mage_s"] / g["unbounded_s"]
    measured = gc_main_measured["planned_over_unbounded"] \
        if gc_main_measured else None
    res["gc_main"].update(simulated_mage_over_unbounded=sim_ratio,
                          measured_planned_over_unbounded=measured)
    log(f"bench: {len(rows)} Fig. 8 cases at budget 0.4, MAGE beats OS on "
        f"every one ({res['bench_s']:.1f} s of host work); tiny streaming "
        f"case ({res['streaming_s']:.1f} s); array cores == scalar cores "
        f"on {[f'{w} {n}' for w, n in BENCH_CORE_CASES]} "
        f"({res['cores_s']:.1f} s)")
    log(f"bench: GC main (merge n={MAIN['n']}, budget 0.4, {g['num_frames']} "
        f"frames, swaps {g['swaps']}): model seconds unbounded "
        f"{g['unbounded_s']:.4f}, OS {g['os_s']:.4f}, MAGE {g['mage_s']:.4f} "
        f"(stall {g['mage_stall_s']:.4f}): simulated MAGE / unbounded "
        f"{sim_ratio:.4f}; measured on the card planned / unbounded "
        f"execute " + (f"{measured:.4f} (baselines phase)" if measured
                       else "not measured in this run"))
    return res


# ---------------------------------------------------------------------------
# the serve daemon: the artifact cache, admission and jobs on the card
# ---------------------------------------------------------------------------

#: the plan-only cases (benchmarks/serve_bench.py:32), at budget 0.4,
#: streaming, submitted SERVE_ROUNDS rounds cold and SERVE_ROUNDS hot
SERVE_PLAN_CASES = [("merge", 4096), ("sort", 2048), ("rsum", 128)]
SERVE_ROUNDS = 5
#: executed on the daemon's card, cold then hot, checked against the
#: oracle: (workload, n, path) -- GC through the half gates, CKKS (at the
#: CKKS main job's width) through the NTT kernels.  merge and aggsum cut
#: 1024 -> 512 for the time limit (PERF.md section 4)
SERVE_EXEC = [("merge", 512, "serve daemon"), ("rsum", 128, "serve daemon"),
              ("aggsum", 512, "aggsum")]
SERVE_BUDGET = dict(memory_budget=0.4, plan_mode="streaming")


def _serve_spec(wl: str, n: int) -> JobSpec:
    extra = dict(ckks_ring=BENCH_CKKS.n_ring, ckks_levels=BENCH_CKKS.levels) \
        if get_workload(wl).protocol == "ckks" else {}
    return JobSpec(wl, n=n, **SERVE_BUDGET, **extra)


def _kernel_delta(after: dict, before: dict) -> tuple[dict, dict]:
    """Two daemon ``status`` kernel counters (``kernels.kernel_counts``) ->
    what ran between them, in ``ops.counts()`` / ``nops.counts()`` form."""
    (gc1, ntt1), (gc0, ntt0) = (_fleet_counts([{"kernel_counts": k}])
                                for k in (after, before))

    def sub(a, b):
        if isinstance(a, dict):
            return {k: sub(v, b.get(k, {} if isinstance(v, dict) else 0))
                    for k, v in a.items()}
        return a - b
    gc, ntt = sub(gc1, gc0), sub(ntt1, ntt0)
    for sizes in (*gc["launch_sizes"].values(),
                  *ntt["launch_sizes"].values(), ntt["mul_shapes"]):
        for m in [m for m, k in sizes.items() if not k]:
            del sizes[m]
    return gc, ntt


def _add_counts(a, b):
    """Two counters of one form, summed (a key either lacks counts 0)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _add_counts(a.get(k), b.get(k)) for k in a.keys() | b.keys()}
    return (a or 0) + (b or 0)


def _start_daemon(tmp: str) -> tuple[subprocess.Popen, str]:
    """``python -m repro_torch serve`` in a process of its own, on the card
    (unix socket; TCP where the path would be too long for one)."""
    from repro_torch.core.transport import pick_free_ports
    sock = os.path.join(tmp, "mage.sock")
    where = ["--socket", sock]
    if len(sock) > 100:
        port = pick_free_ports(1)[0]
        where, sock = ["--port", str(port)], f"127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    log_path = os.path.join(tmp, "daemon.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m", "repro_torch",
         "serve", "--cache",
             os.path.join(tmp, "cache"), *where], env=env, stdout=logf,
            stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    deadline = time.monotonic() + 120
    while True:
        with open(log_path) as f:
            if "serving on" in f.read():
                return proc, sock
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(log_path) as f:
                raise AssertionError(f"serve daemon did not start:\n"
                                     f"{f.read()}")
        time.sleep(0.05)


def _serve_plan_rounds(c) -> dict:
    """The plan-only cases, SERVE_ROUNDS rounds cold (no cache), one warm
    pass, then SERVE_ROUNDS rounds hot: jobs/s both ways, hot digests ==
    cold, and the daemon's own counters show no trace and no plan hot."""
    specs = [JobSpec(w, n=n, **SERVE_BUDGET) for w, n in SERVE_PLAN_CASES]

    def drive(use_cache: bool) -> dict:
        digests = {}
        t0 = time.perf_counter()
        for _ in range(SERVE_ROUNDS):
            for spec in specs:
                r = c.submit(spec, use_cache=use_cache)
                digests[f"{spec.workload}/{spec.n}"] = r["digests"]["plan"]
        dt = time.perf_counter() - t0
        return {"jobs": SERVE_ROUNDS * len(specs), "seconds": dt,
                "jobs_per_s": SERVE_ROUNDS * len(specs) / dt,
                "digests": digests}
    cold = drive(False)
    for spec in specs:
        c.submit(spec)
    before = c.status()["cache"]
    hot = drive(True)
    after = c.status()["cache"]
    if after["trace_misses"] != before["trace_misses"] or \
            after["plan_misses"] != before["plan_misses"] or \
            after["plan_hits"] != before["plan_hits"] + hot["jobs"]:
        raise AssertionError(f"serve daemon: the hot rounds traced or "
                             f"planned: {before} -> {after}")
    if hot["digests"] != cold["digests"]:
        raise AssertionError("serve daemon: hot plan digests != cold")
    log(f"serve daemon: plan only {SERVE_PLAN_CASES} at budget 0.4, "
        f"streaming: cold {cold['jobs_per_s']:.2f} jobs/s ({cold['jobs']} "
        f"jobs, {cold['seconds']:.2f} s), hot {hot['jobs_per_s']:.2f} "
        f"jobs/s ({hot['seconds']:.2f} s), "
        f"{hot['jobs_per_s'] / cold['jobs_per_s']:.2f}x; hot digests == "
        f"cold; hot rounds: 0 trace misses, 0 plan misses, "
        f"{after['plan_hits'] - before['plan_hits']} plan hits")
    return {"cold": {k: v for k, v in cold.items() if k != "digests"},
            "hot": {k: v for k, v in hot.items() if k != "digests"},
            "speedup": hot["jobs_per_s"] / cold["jobs_per_s"]}


def _serve_exec(c) -> tuple[dict, dict]:
    """SERVE_EXEC on the daemon's card, cold then hot: the hot run's plan
    and outputs digests equal the cold run's, its plan and batch schedule
    hit, and both launch the same kernels.  Returns the metrics and each
    path's kernel counters (the daemon's, read just before and after)."""
    res, paths = {}, {}
    for wl, n, path in SERVE_EXEC:
        spec = _serve_spec(wl, n)
        k0 = c.status()["kernels"]
        cold = c.submit(spec, execute=True, check=True)
        k1 = c.status()["kernels"]
        hot = c.submit(spec, execute=True, check=True)
        k2 = c.status()["kernels"]
        (gc_c, ntt_c), (gc_h, ntt_h) = _kernel_delta(k1, k0), \
            _kernel_delta(k2, k1)
        want = {"trace": "skipped", "plan": "hit", "batch": "hit"}
        if hot["cache"] != want or cold["cache"]["plan"] != "miss":
            raise AssertionError(f"serve daemon {wl} {n}: cache events cold "
                                 f"{cold['cache']}, hot {hot['cache']}")
        if hot["outputs_digest"] != cold["outputs_digest"] or \
                hot["digests"] != cold["digests"]:
            raise AssertionError(f"serve daemon {wl} {n}: hot digests != "
                                 f"cold")
        if (gc_c, ntt_c) != (gc_h, ntt_h):
            raise AssertionError(f"serve daemon {wl} {n}: hot launches != "
                                 f"cold")
        if any(ntt_c["plain_calls"].values()):
            raise AssertionError(f"serve daemon {wl} {n}: plain NTT calls "
                                 f"{ntt_c['plain_calls']}")
        gc_run = get_workload(wl).protocol == "gc"
        if (gc_run and not (gc_c["garble_launches"] and
                            gc_c["eval_launches"])) or \
                (not gc_run and not ntt_c["launches"]["ntt_mul"]):
            raise AssertionError(f"serve daemon {wl} {n}: no kernel launch "
                                 f"({gc_c['garble_launches']} garble, "
                                 f"{ntt_c['launches']})")
        both = (_add_counts(gc_c, gc_h), _add_counts(ntt_c, ntt_h))
        paths[path] = both if path not in paths else \
            tuple(_add_counts(a, b) for a, b in zip(paths[path], both))
        res[f"{wl}-{n}"] = {
            "frames": cold["frames"],
            "cold_s": cold["timings"]["total_s"],
            "hot_s": hot["timings"]["total_s"],
            "cold_execute_s": cold["timings"]["execute_s"],
            "hot_execute_s": hot["timings"]["execute_s"],
            "hot_plan_s": hot["timings"]["plan_s"],
            "cold_plan_s": cold["timings"]["plan_s"],
            "garble_launches": gc_c["garble_launches"],
            "ands": gc_c["garble_ands"],
            "ntt_launches": ntt_c["launches"]}
        log(f"serve daemon: {wl} n={n} at 0.4 ({cold['frames']} frames) on "
            f"the card, checked: cold {cold['timings']['total_s']:.3f} s "
            f"(plan {cold['timings']['plan_s']:.3f}, execute "
            f"{cold['timings']['execute_s']:.3f}), hot "
            f"{hot['timings']['total_s']:.3f} s (plan "
            f"{hot['timings']['plan_s']:.4f}, execute "
            f"{hot['timings']['execute_s']:.3f}); outputs digest "
            f"{hot['outputs_digest']} both; each run "
            + (f"{gc_c['garble_launches']} garble / {gc_c['eval_launches']} "
               f"eval launches ({gc_c['garble_ands']} ANDs)" if gc_run else
               f"NTT launches {ntt_c['launches']}"))
    return res, paths


def _serve_admission(c, address: str) -> dict:
    """An oversized job is rejected (through ``python -m repro_torch
    submit``: exit 3); two clients served at once, each job's outputs
    equal to its single run's."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "submit", "--connect",
         address, "--workload", "merge", "-n", "1024", "--budget",
         "1000000"], env=env, capture_output=True, text=True, timeout=120)
    if out.returncode != 3 or "never be admitted" not in out.stderr:
        raise AssertionError(f"serve daemon: oversized job: exit "
                             f"{out.returncode}, {out.stderr[-400:]}")
    from repro_torch.serve_daemon import serve_client
    jobs = {"rsum": _serve_spec("rsum", 128),
            "aggsum": JobSpec("aggsum", n=64, **SERVE_BUDGET)}
    single = {k: c.submit(s, execute=True, check=True)["outputs_digest"]
              for k, s in jobs.items()}
    got, errs = {}, []
    a0 = c.status()["admission"]

    def tenant(name):
        try:
            with serve_client(address) as cc:
                got[name] = cc.submit(jobs[name], execute=True, check=True)
        except Exception as e:            # noqa: BLE001 (raised below)
            errs.append(e)
    threads = [threading.Thread(target=tenant, args=(k,)) for k in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    both_s = time.perf_counter() - t0
    if errs:
        raise errs[0]
    a1 = c.status()["admission"]
    if {k: r["outputs_digest"] for k, r in got.items()} != single or \
            a1["admitted"] != a0["admitted"] + 2 or a1["active"]:
        raise AssertionError(f"serve daemon: two tenants: {got}, {a1}")
    log(f"serve daemon: oversized job rejected through `submit` (exit 3); "
        f"two clients at once (rsum 128 and aggsum 64, both executed on the "
        f"card) served in {both_s:.3f} s, outputs equal to their single "
        f"runs; admission {a1}")
    return {"two_tenants_s": both_s, "admission": a1,
            "tenant_s": {k: r["timings"]["total_s"] for k, r in got.items()}}


def phase_serve_daemon(dev) -> tuple[dict, dict]:
    """The serve daemon as a process of its own on the card: plan-only
    rounds cold and hot, jobs executed on the card cold and hot, and
    admission.  Returns the metrics and each executed path's kernel
    counters."""
    import tempfile
    from repro_torch.serve_daemon import serve_client
    tmp = tempfile.mkdtemp(prefix="mage_serve_")
    t0 = time.perf_counter()
    proc, address = _start_daemon(tmp)
    start_s = time.perf_counter() - t0
    try:
        with serve_client(address) as c:
            st = c.status()
            if not st["device"].startswith("cuda"):
                raise AssertionError(f"serve daemon on {st['device']}")
            res = {"start_s": start_s, "plan": _serve_plan_rounds(c)}
            res["exec"], paths = _serve_exec(c)
            res["admission"] = _serve_admission(c, address)
            res["cache"] = c.status()["cache"]
            c.shutdown()
        t0 = time.perf_counter()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)     # faulthandler: the stacks
            proc.wait(timeout=30)
            with open(os.path.join(tmp, "daemon.log")) as f:
                raise AssertionError(f"serve daemon: still running 30 s "
                                     f"after shutdown:\n{f.read()[-6000:]}")
        res["exit_s"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serve daemon: up in {start_s:.2f} s; cache at the end "
        f"{res['cache']['entries']} entries, {res['cache']['total_bytes']} "
        f"bytes, {res['cache']['invalid']} invalid")
    return res, paths


# ---------------------------------------------------------------------------
# secure aggregation: the servers' share matrices and sums on the card
# ---------------------------------------------------------------------------

#: benchmarks/agg_bench.py:37-48: 2000 clients x 64 words x 3 rounds, the
#: fan-in row's 256 KiB in-flight bound, its WAN of 2 ms and 200 MB/s
AGG_FULL = dict(clients=2000, vec_len=64, rounds=3)
AGG_INFLIGHT = 256 << 10
AGG_WAN = FabricSpec(latency_s=0.002, bandwidth=200e6)
#: a model update: 512 KiB a share, a 512 MiB share matrix a server
AGG_MODEL = dict(clients=1000, vec_len=65536, rounds=1)
#: the four-process run over localhost TCP
AGG_TCP = dict(clients=2000, vec_len=64, rounds=1)


def _agg_bounded(res, spec) -> int:
    """Every gateway link's reorder peak at or under the knob plus the
    largest message it carries; returns the worst peak."""
    from repro_torch.aggregate import build_round_plan, largest_message
    plan = build_round_plan(spec)
    worst = 0
    for (src, dst), st in res.reorder.items():
        if dst < spec.servers <= src:
            big = largest_message(spec, plan, src - spec.servers)
            worst = max(worst, st.peak_bytes)
            if st.max_bytes != spec.max_inflight_bytes or \
                    st.peak_bytes > st.max_bytes + big:
                raise AssertionError(f"aggregate: link {src}->{dst} peak "
                                     f"{st.peak_bytes} B over the knob "
                                     f"{st.max_bytes} + {big} B")
    return worst


def _agg_wraps(dev) -> None:
    """The server's reduction on the card: an int64 sum over words near
    2**64 equals the uint64 sum mod 2**64 (NumPy)."""
    rng = np.random.default_rng(64)
    x = np.uint64(2**64 - 1) - rng.integers(0, 1 << 20, (2000, 64),
                                            dtype=np.uint64)
    got = torch.from_numpy(x.view(np.int64)).to(dev).sum(dim=0).cpu()
    if not np.array_equal(got.numpy().view(np.uint64),
                          x.sum(axis=0, dtype=np.uint64)):
        raise AssertionError("aggregate: the card's int64 sum does not wrap "
                             "as the uint64 sum")


def _agg_run(name: str, spec, dev, **kw) -> tuple[dict, object]:
    from repro_torch.aggregate import run_aggregation, verify_aggregates
    res = run_aggregation(spec, device=dev, **kw)
    verify_aggregates(res)
    if len(res.rounds) != spec.rounds or res.device != str(dev):
        raise AssertionError(f"aggregate {name}: {len(res.rounds)} rounds on "
                             f"{res.device}")
    out = {"seconds": res.seconds, "clients_per_s": res.clients_per_s,
           "latency_ms": res.latency_ms,
           "link_bytes": sum(st.bytes for st in res.link_totals.values()),
           "peak_frames": res.admission["peak_frames"],
           "plan_events": res.plan_events}
    return out, res


def _agg_tcp(spec, dev, tmp: str) -> dict:
    """The same job as four processes, one a rank, over localhost TCP
    (``python -m repro_torch agg --rank K``): rank 0's aggregates and
    survivors and every rank's link bytes equal the in-process run's."""
    from repro_torch.core.transport import pick_free_ports
    _, want = _agg_run("tcp reference", spec, dev)
    ranks = spec.num_endpoints
    peers = ",".join(f"127.0.0.1:{p}" for p in pick_free_ports(ranks))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    args = ["--clients", str(spec.clients), "--vec-len", str(spec.vec_len),
            "--rounds", str(spec.rounds), "--servers", str(spec.servers),
            "--gateways", str(spec.gateways), "--peers", peers]
    outs = [os.path.join(tmp, f"agg{k}.json") for k in range(ranks)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "agg", *args, "--rank",
         str(k), "--json", outs[k]] + (["--check"] if k == 0 else []),
        env=env, stdout=subprocess.DEVNULL) for k in range(ranks)]
    try:
        for k, p in enumerate(procs):
            if p.wait(timeout=180) != 0:
                raise AssertionError(f"aggregate tcp: rank {k} exit "
                                     f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    docs = []
    for o in outs:
        with open(o) as f:
            docs.append(json.load(f))
    got = docs[0]["rounds"]
    links = {k: v for d in docs for k, v in d["link_totals"].items()}
    want_links = {f"{s}->{d}": {"messages": st.messages, "bytes": st.bytes}
                  for (s, d), st in want.link_totals.items()}
    if [r["aggregate"] for r in got] != [[int(v) for v in r.total]
                                         for r in want.rounds] or \
            [r["survivors"] for r in got] != [r.survivors
                                              for r in want.rounds] or \
            links != want_links:
        raise AssertionError("aggregate tcp: four processes != in-process")
    if not docs[0]["device"].startswith("cuda"):
        raise AssertionError(f"aggregate tcp: rank 0 on {docs[0]['device']}")
    return {"wall_s": wall, "rank0_s": docs[0]["seconds"],
            "link_bytes": sum(v["bytes"] for v in links.values())}


def phase_aggregate(dev) -> dict:
    """Secure aggregation with the servers on the card: agg_bench's three
    rows at full size (fan-in under the 256 KiB bound, the shaped WAN,
    the plan cache cold then hot), a model-update round (a 512 MiB share
    matrix a server), and four processes over TCP against the in-process
    run; every round checked bit for bit by verify_aggregates."""
    import tempfile
    from repro_torch.aggregate import AggSpec
    from repro_torch.serve_daemon import ArtifactCache
    _agg_wraps(dev)
    res = {}
    spec = AggSpec(**AGG_FULL, max_inflight_bytes=AGG_INFLIGHT)
    res["fanin"], r = _agg_run("fan-in", spec, dev)
    res["fanin"]["reorder_peak_bytes"] = _agg_bounded(r, spec)
    log(f"aggregate: fan-in {AGG_FULL} on the card, every round bit for "
        f"bit: {r.clients_per_s:.0f} clients/s ({r.seconds:.3f} s), latency "
        f"{ {k: round(v, 3) for k, v in r.latency_ms.items()} } ms, reorder "
        f"peak {res['fanin']['reorder_peak_bytes']} B under the "
        f"{AGG_INFLIGHT} B knob + the largest message, admission peak "
        f"{r.admission['peak_frames']} frames")
    res["wan"], r = _agg_run("wan", spec, dev, transport="shaped",
                             fabric_spec=AGG_WAN)
    if not r.latency_ms or r.latency_ms["p50"] < 1e3 * AGG_WAN.latency_s:
        raise AssertionError(f"aggregate wan: latency {r.latency_ms}")
    log(f"aggregate: shaped WAN ({AGG_WAN.latency_s * 1e3:.0f} ms, "
        f"{AGG_WAN.bandwidth / 1e6:.0f} MB/s): {r.clients_per_s:.0f} "
        f"clients/s, latency p50/p90/p99 "
        + "/".join(f"{r.latency_ms[q]:.3f}" for q in ("p50", "p90", "p99"))
        + f" ms, {res['wan']['link_bytes']} B on the links")
    with tempfile.TemporaryDirectory(prefix="mage_agg_") as tmp:
        spec = AggSpec(**AGG_FULL)
        cold_cache = ArtifactCache(os.path.join(tmp, "cache"))
        cold, _ = _agg_run("plan cache cold", spec, dev, cache=cold_cache)
        hot_cache = ArtifactCache(os.path.join(tmp, "cache"))
        hot, _ = _agg_run("plan cache hot", spec, dev, cache=hot_cache)
        if cold["plan_events"] != ["miss"] + ["hit"] * (spec.rounds - 1) or \
                hot["plan_events"] != ["hit"] * spec.rounds or \
                hot_cache.stats.agg_misses != 0:
            raise AssertionError(f"aggregate plan cache: cold "
                                 f"{cold['plan_events']}, hot "
                                 f"{hot['plan_events']}")
        res["plan_cache"] = {"cold": cold, "hot": hot}
        log(f"aggregate: plan cache cold {cold['plan_events']}, hot "
            f"{hot['plan_events']} (agg_misses 0): {cold['seconds']:.3f} / "
            f"{hot['seconds']:.3f} s")
        spec = AggSpec(**AGG_MODEL)
        torch.cuda.reset_peak_memory_stats(dev)
        res["model"], r = _agg_run("model update", spec, dev)
        res["model"]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(dev)
        log(f"aggregate: model update {AGG_MODEL} (512 KiB a share, a "
            f"{spec.clients * spec.vec_len * 8 >> 20} MiB share matrix a "
            f"server on the card), bit for bit: {r.seconds:.3f} s, "
            f"{r.clients_per_s:.0f} clients/s, max_memory_allocated "
            f"{res['model']['max_memory_allocated']} B")
        res["tcp"] = _agg_tcp(AggSpec(**AGG_TCP), dev, tmp)
    log(f"aggregate: {AGG_TCP} as four processes over localhost TCP (2 "
        f"servers on the card, 2 gateways) == in process: aggregates, "
        f"survivors and link bytes ({res['tcp']['link_bytes']} B); wall "
        f"{res['tcp']['wall_s']:.2f} s, rank 0 {res['tcp']['rank0_s']:.3f} "
        f"s")
    return res


# ---------------------------------------------------------------------------
# the serving path: paged-attention kernel, parity, main job, record, profile
# ---------------------------------------------------------------------------

#: qwen2-1.5b at full width (src/repro_torch/configs/qwen2_1_5b.py)
QWEN2 = get_config("qwen2-1.5b")
#: tokens per KV page: PagedKVConfig's default
PAGE = 64
#: the serve main job: 4 requests of 200 prompt tokens, 64 new tokens each;
#: max_seq = prompt + max_new + 1 as the launcher sets it (5 pages, the last
#: ragged); the launcher's batch size 2
SERVE_MAIN = dict(n_req=4, prompt=200, max_new=64, max_seq=265, batch=2)
#: small enough for the CPU, two pages with the last ragged
SERVE_PARITY = dict(n_req=3, prompt=70, max_new=8, max_seq=79, batch=2)
#: the repo's decode_32k context (configs SHAPES) at batch 8
LONG_BATCH, LONG_LEN = 8, 32768
#: the kernel against its plain version: both take the same values up to
#: float32 and compute in float32, so the f32 tolerance holds for bf16 pages
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
#: paged decode against the contiguous decode: the reference's own bound
#: between its prefill and its forward (tests/test_models.py)
SERVE_REL = 3e-2
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12
#: the paged-attention call's kernels: the split kernel (one per call)
#: and, where a sequence has more than one chunk, the combine kernel
ATTN_KERNELS = ("paged_attn_split_kernel", "paged_attn_combine_kernel")
#: stablelm-3b at full width (src/repro_torch/configs/stablelm_3b.py):
#: head_dim 80, 32 query heads over 32 KV heads
STABLELM = get_config("stablelm-3b")
#: its paged serve: 1 request of a 64-token prompt, 8 new tokens
SERVE_STABLELM = dict(n_req=1, prompt=64, max_new=8, max_seq=73, batch=2)
#: the serve families phase (src/repro_torch/configs/*.py), each at its
#: published widths and depth: a MoE model, the Mamba2 hybrid (its shared
#: block's head_dim is 112), xLSTM and the encoder-decoder
DEEPSEEK = get_config("deepseek-moe-16b")
ZAMBA2 = get_config("zamba2-7b")
XLSTM = get_config("xlstm-1.3b")
SEAMLESS = get_config("seamless-m4t-medium")
#: 2 requests of 128 prompt tokens and 16 new ones each (the launcher's
#: max_seq rule)
FAMILY_JOB = dict(n_req=2, prompt=128, max_new=16, max_seq=145, batch=2)
#: the encoder-decoder: batch 2, 256 seeded frames, a 16-token prompt fed a
#: token at a time, then 16 greedy steps
ENCDEC_JOB = dict(batch=2, frames=256, prompt=16, max_new=16)
#: qwen2-1.5b's int8 KV cache beside its bf16 one
INT8_JOB = dict(n_req=2, prompt=200, max_new=16, max_seq=217, batch=2)
#: a prompt at the reference's CHUNKED_SDPA_THRESHOLD, then paged steps
LONG_PROMPT, LONG_STEPS = 8192, 8
#: chunked attention against the dense formula, both in float32
CHUNKED_REL = 1e-4
#: a family's paged decode against its contiguous decode, both in float32
#: at full width (bf16 rounding of seeded weights amplified through 28 to
#: 94 layers makes the bf16 decodes differ by more than SERVE_REL: the f32
#: model is where the two paths are held to each other)
F32_REL = 1e-3
#: the families held card against CPU at their reduced configs in f32
#: (tests/test_torch_lm_families.py's FAMILIES), within the tests' 1e-4
FAMILY_PARITY = [("deepseek-moe-16b", "bfloat16"),
                 ("phi3.5-moe-42b-a6.6b", "bfloat16"),
                 ("zamba2-7b", "bfloat16"), ("xlstm-1.3b", "bfloat16"),
                 ("chameleon-34b", "bfloat16"),
                 ("seamless-m4t-medium", "bfloat16"), ("qwen2-1.5b", "int8")]
PARITY_REL = 1e-4
#: lengths at the kernel's edges: one token, either side of a page (and of
#: a four-warp tile), a 2-page chunk exactly and plus one, decode_32k
ATTN_EDGES = (1, 63, 64, 65, 128, 129, 32768)


def _attn_kernel_name(key: str) -> str:
    for name in ATTN_KERNELS:
        if name in key:
            return name
    return key


def _attn_inputs(seed: int, batch: int, qh: int, kvh: int, hd: int,
                 psz: int, mp: int, dtype, dev, lens=None,
                 tails: bool = True):
    """q on the card, K/V pages drawn on the card, permuted block tables
    (-1 past each sequence's pages when ``tails``) and lengths on the host,
    as the wrapper takes them."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    num_pages = batch * mp + 2
    q = torch.randn((batch, qh, hd), generator=gen, device=dev)
    kp = torch.randn((num_pages, psz, kvh, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((num_pages, psz, kvh, hd), generator=gen,
                     device=dev).to(dtype)
    sl = np.asarray(lens if lens is not None else
                    rng.integers(1, mp * psz + 1, batch), dtype=np.int32)
    bt = rng.permutation(num_pages)[:batch * mp].reshape(batch, mp) \
        .astype(np.int32)
    if tails:
        bt[np.arange(mp)[None, :] >= -(-sl[:, None] // psz)] = -1
    return q, kp, vp, bt, sl


def _attn_plain(q, kp, vp, bt, sl):
    return pref.paged_decode_attention(
        q, kp, vp, torch.from_numpy(bt).to(q.device),
        torch.from_numpy(sl).to(q.device))


def _attn_tables(x, chunk_pages=None):
    q, kp, vp, bt, sl = x
    return pops.prepare_tables(bt, sl, page_size=kp.shape[1],
                               num_pages=kp.shape[0], kv_heads=kp.shape[2],
                               device=q.device, chunk_pages=chunk_pages)


def _attn_check(x, what: str, tables=None) -> float:
    """The kernel against its plain version on the same inputs, over the
    host tables or over ``tables`` prepared from them; returns max |kernel
    - plain|."""
    got = pops.paged_decode_attention(*x) if tables is None else \
        pops.paged_decode_attention(*x[:3], tables=tables)
    want = _attn_plain(*x)
    torch.cuda.synchronize()
    bad = (got - want).abs() > ATTN_ATOL + ATTN_RTOL * want.abs()
    err = float((got - want).abs().max())
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"paged attention != plain at {what}: "
                             f"max_abs_err {err}")
    return err


def phase_attn_kernels(dev) -> float:
    """The paged-attention kernel against its plain version; returns the
    max_abs_err over the comparisons."""
    err, cases = 0.0, 0
    sweep = [(2, 8, 2, 64, 16, 4), (3, 4, 4, 32, 8, 3),
             (1, 16, 8, 128, 32, 2), (4, 2, 1, 64, 8, 5)]
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(sweep):
            for tails in (False, True):
                err = max(err, _attn_check(
                    _attn_inputs(i, *shape, dtype, dev, tails=tails),
                    f"{shape} {dtype} tails={tails}"))
                cases += 1
        for batch in (1, 8):      # qwen2's heads, ragged, permuted, tails
            shape = (batch, QWEN2.n_heads, QWEN2.n_kv_heads, QWEN2.head_dim,
                     PAGE, 5)
            err = max(err, _attn_check(_attn_inputs(10 + batch, *shape,
                                                    dtype, dev),
                                       f"qwen2 {shape} {dtype}"))
            cases += 1
        # a single query ending mid-page (tests/test_kernels.py)
        err = max(err, _attn_check(_attn_inputs(7, 1, 4, 2, 32, 8, 2, dtype,
                                                dev, lens=[3]),
                                   f"single query {dtype}"))
        cases += 1
    # full pages in bf16 (tests/test_kernels.py's bf16 case)
    err = max(err, _attn_check(_attn_inputs(0, 2, 4, 2, 64, 16, 3,
                                            torch.bfloat16, dev,
                                            lens=[48, 48]), "bf16 full"))
    lens = np.random.default_rng(32).integers(1, LONG_LEN + 1, LONG_BATCH)
    lens[0] = LONG_LEN
    x = _attn_inputs(32, LONG_BATCH, QWEN2.n_heads, QWEN2.n_kv_heads,
                     QWEN2.head_dim, PAGE, LONG_LEN // PAGE, torch.bfloat16,
                     dev, lens=lens)
    err = max(err, _attn_check(x, f"batch 8 up to {LONG_LEN} tokens"))
    err = max(err, _attn_check(x, f"batch 8 up to {LONG_LEN}, prepared",
                               _attn_tables(x)))
    cases += 3
    # the edges: each length and one more, qwen2's heads, over host tables
    # and over tables prepared with 2-page chunks (128 and 129 end a chunk
    # and start one); stablelm-3b's heads (head_dim 80, group 1); a group
    # of 16 (the kernel's two n-tiles)
    edge = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in ATTN_EDGES:
            lens2 = [n, min(n + 1, LONG_LEN)]
            x = _attn_inputs(100 + n, 2, QWEN2.n_heads, QWEN2.n_kv_heads,
                             QWEN2.head_dim, PAGE, -(-max(lens2) // PAGE),
                             dtype, dev, lens=lens2)
            edge = max(edge, _attn_check(x, f"lengths {lens2} {dtype}"))
            edge = max(edge, _attn_check(x, f"lengths {lens2} {dtype}, "
                                         f"2-page chunks",
                                         _attn_tables(x, 2)))
            cases += 2
        for lens2 in ([1, 73], [129, 64], [2048, 300]):
            x = _attn_inputs(7 + lens2[0], 2, STABLELM.n_heads,
                             STABLELM.n_kv_heads, STABLELM.head_dim, PAGE,
                             -(-max(lens2) // PAGE), dtype, dev, lens=lens2)
            edge = max(edge, _attn_check(x, f"stablelm {lens2} {dtype}"))
            edge = max(edge, _attn_check(x, f"stablelm {lens2} {dtype}, "
                                         f"1-page chunks",
                                         _attn_tables(x, 1)))
            cases += 2
        x = _attn_inputs(16, 3, 32, 2, 64, 16, 6, dtype, dev)
        edge = max(edge, _attn_check(x, f"group 16 {dtype}"))
        edge = max(edge, _attn_check(x, f"group 16 {dtype}, prepared",
                                     _attn_tables(x, 2)))
        cases += 2
        # the serve families' heads: zamba2-7b's shared block (head_dim
        # 112) and deepseek-moe-16b's, at their prompts' lengths and
        # beyond a page
        for name, cfg in (("zamba2", ZAMBA2), ("deepseek", DEEPSEEK)):
            for lens2 in ([129, 144], [1, 200], [LONG_PROMPT, 65]):
                x = _attn_inputs(lens2[0] + cfg.head_dim, 2, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, PAGE,
                                 -(-max(lens2) // PAGE), dtype, dev,
                                 lens=lens2)
                edge = max(edge, _attn_check(x, f"{name} {lens2} {dtype}"))
                edge = max(edge, _attn_check(x, f"{name} {lens2} {dtype}, "
                                             f"2-page chunks",
                                             _attn_tables(x, 2)))
                cases += 2
    err = max(err, edge)
    log(f"attn kernels: paged_decode_attention equals its plain version "
        f"within rtol {ATTN_RTOL} / atol {ATTN_ATOL} in {cases} cases (f32 "
        f"and bf16 pages: the JAX package's shapes, full and with -1 tails; "
        f"qwen2's heads at batch 1 and 8; a single ragged query; batch "
        f"{LONG_BATCH} at lengths {sorted(lens.tolist())} in bf16, over "
        f"host and prepared tables; lengths {ATTN_EDGES} and one more, over "
        f"host tables and 2-page chunks; stablelm-3b's heads; a group of "
        f"16; zamba2-7b's heads of 112 and deepseek-moe-16b's); "
        f"max_abs_err {err:.3e} (the edges' {edge:.3e})")
    return err


def _prompts(seed: int, cfg, job: dict) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, job["prompt"])
            for _ in range(job["n_req"])]


def _serve(model, cfg, prompts, job: dict, paged: bool):
    reqs = [Request(i, p, max_new=job["max_new"])
            for i, p in enumerate(prompts)]
    st = run_server(cfg, reqs, job["batch"], job["max_seq"], paged=paged,
                    params=model)
    return [r.output for r in reqs], st


def _forced_logits(model, cfg, prompt, tokens, paged: bool,
                   max_seq: int, times: dict | None = None) -> torch.Tensor:
    """(len(tokens), vocab) logits of the prefill and of each decode step
    fed ``tokens`` (teacher forcing), through the paged or the contiguous
    decode; ``times`` (if given) gains the prefill's and the decode's
    seconds, each synchronised."""
    dev = model.device
    with torch.inference_mode():
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(prompt), device=dev)[None]
        plen = toks.shape[1]
        logits, caches = lm_prefill(model, toks, cfg,
                                    plen if paged else max_seq)
        rows = [logits[0, -1]]
        if paged:
            caches, clen = paged_cache(cfg, caches, max_seq), None
        else:
            clen = torch.tensor([plen], device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in tokens[:-1]:
            logits, caches = lm_decode(
                model, torch.tensor([[t]], device=dev), caches, clen, cfg)
            if clen is not None:
                clen = clen + 1
            rows.append(logits[0, -1])
        torch.cuda.synchronize()
    if times is not None:
        times["prefill_s"] = times.get("prefill_s", 0.0) + t1 - t0
        times["decode_s"] = times.get("decode_s", 0.0) + \
            time.perf_counter() - t1
        times["steps"] = times.get("steps", 0) + len(tokens) - 1
    return torch.stack(rows)


def _rel_per_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max |a - b| / max |b| of every row."""
    return (a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1e-6)


def phase_serve_parity(dev) -> dict:
    """Reduced qwen2 in f32 with nonzero biases, on the card and on the
    CPU: equal greedy tokens, teacher-forced logits within relative 1e-4
    (both sides in full f32), for the paged and the contiguous decode."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32")
    cpu_model = init_lm(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    for blk in cpu_model.blocks:
        for name in ("q_bias", "k_bias", "v_bias"):
            b = getattr(blk.attn, name)
            b.copy_(torch.randn(b.shape, generator=gen) * 0.5)
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompts = _prompts(3, cfg, SERVE_PARITY)
    out = {}
    for paged in (True, False):
        t0 = time.perf_counter()
        want, _ = _serve(cpu_model, cfg, prompts, SERVE_PARITY, paged)
        t_cpu = time.perf_counter() - t0
        pops.reset_counts()
        t0 = time.perf_counter()
        got, _ = _serve(card_model, cfg, prompts, SERVE_PARITY, paged)
        t_card = time.perf_counter() - t0
        c = pops.counts()
        steps = SERVE_PARITY["n_req"] * (SERVE_PARITY["max_new"] - 1)
        if c["launches"] != (steps * cfg.n_layers if paged else 0) or \
                c["plain_calls"]:
            raise AssertionError(f"serve parity paged={paged}: counts {c}")
        if got != want:
            raise AssertionError(f"serve parity paged={paged}: card tokens "
                                 f"{got} != CPU tokens {want}")
        worst = 0.0
        for p, toks in zip(prompts, want):
            lc = _forced_logits(cpu_model, cfg, p, toks, paged,
                                SERVE_PARITY["max_seq"])
            lg = _forced_logits(card_model, cfg, p, toks, paged,
                                SERVE_PARITY["max_seq"]).cpu()
            worst = max(worst, float(_rel_per_step(lg, lc).max()))
        if worst >= 1e-4:
            raise AssertionError(f"serve parity paged={paged}: logits differ"
                                 f" by relative {worst}")
        kind = "paged" if paged else "contiguous"
        log(f"serve parity ({kind}): reduced qwen2 f32, {len(prompts)} "
            f"requests x {SERVE_PARITY['max_new']} tokens, on the card "
            f"({t_card:.2f} s) == on the CPU ({t_cpu:.2f} s): greedy tokens "
            f"equal, teacher-forced logits within relative {worst:.3e} "
            f"(limit 1e-4); kernel launches {c['launches']}")
        out[kind] = {"card_s": t_card, "cpu_s": t_cpu, "max_rel": worst}
    return out


def _decode_turns(model, cfg, prompt, max_seq: int, steps: int = 32,
                  rounds: int = 2) -> dict:
    """ms per decode step of the paged and the contiguous decode after the
    same prompt, ``steps`` greedy steps each synchronised by its token, in
    turns (paged, contiguous, contiguous, paged) for ``rounds`` rounds: the
    host's pace moves between runs, so the two are compared only in
    turns."""
    dev = model.device
    out = {"paged": [], "contiguous": []}
    with torch.inference_mode():
        toks = torch.as_tensor(np.asarray(prompt), device=dev)[None]
        for _ in range(rounds):
            for paged in (True, False, False, True):
                logits, caches = lm_prefill(model, toks, cfg, toks.shape[1]
                                            if paged else max_seq)
                if paged:
                    caches, clen = paged_cache(cfg, caches, max_seq), None
                else:
                    clen = torch.tensor([toks.shape[1]], device=dev)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    logits, caches = lm_decode(model, tok, caches, clen, cfg)
                    if clen is not None:
                        clen = clen + 1
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                    int(tok[0, 0])
                out["paged" if paged else "contiguous"].append(
                    (time.perf_counter() - t0) / steps * 1e3)
    return out


def phase_serve_main(dev) -> tuple[dict, dict, object]:
    """qwen2-1.5b at full width through run_server with the paged decode;
    returns the kernel's counts from that run, its metrics and the model."""
    cfg = QWEN2
    job = SERVE_MAIN
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = _prompts(0, cfg, job)
    torch.cuda.reset_peak_memory_stats(dev)
    pops.reset_counts()
    toks_p, st = _serve(model, cfg, prompts, job, paged=True)
    counts = pops.counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = job["n_req"] * (job["max_new"] - 1)
    if st.decode_tokens != steps or \
            counts["launches"] != steps * cfg.n_layers or \
            counts["plain_calls"]:
        raise AssertionError(f"serve main: {st.decode_tokens} decode steps, "
                             f"kernel counts {counts}; expected {steps} x "
                             f"{cfg.n_layers} launches")
    if any(len(t) != job["max_new"] or min(t) < 0 or
           max(t) >= cfg.vocab_size for t in toks_p):
        raise AssertionError("serve main: malformed outputs")
    toks_c, st_c = _serve(model, cfg, prompts, job, paged=False)
    agree = sum(a == b for tp, tc in zip(toks_p, toks_c)
                for a, b in zip(tp, tc)) / (job["n_req"] * job["max_new"])
    worst, same_p, same_c = 0.0, 0, 0
    for p, toks in zip(prompts, toks_p):
        lp = _forced_logits(model, cfg, p, toks, True, job["max_seq"])
        lc = _forced_logits(model, cfg, p, toks, False, job["max_seq"])
        if not bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()):
            raise AssertionError("serve main: non-finite logits")
        worst = max(worst, float(_rel_per_step(lp, lc).max()))
        want = torch.tensor(toks, device=dev)
        same_p += int((lp.argmax(-1) == want).sum())
        same_c += int((lc.argmax(-1) == want).sum())
    if worst >= SERVE_REL:
        raise AssertionError(f"serve main: paged logits differ from the "
                             f"contiguous decode's by relative {worst}")
    turns = _decode_turns(model, cfg, prompts[0], job["max_seq"])
    n_tok = job["n_req"] * job["max_new"]
    m = {"arch": cfg.name, "n_req": job["n_req"], "prompt": job["prompt"],
         "max_new": job["max_new"], "max_seq": job["max_seq"],
         "init_s": init_s, "weight_bytes": weight_bytes,
         "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
         "prefill_tokens_per_s": st.prefill_tokens / st.prefill_s,
         "decode_tokens": st.decode_tokens, "decode_s": st.decode_s,
         "decode_tokens_per_s": st.decode_tokens / st.decode_s,
         "ms_per_decode_step": st.decode_s / st.decode_tokens * 1e3,
         "contiguous_decode_s": st_c.decode_s,
         "contiguous_ms_per_decode_step":
             st_c.decode_s / st_c.decode_tokens * 1e3,
         "max_memory_allocated": peak, "launches": counts["launches"],
         "kv_tokens_read": counts["tokens"], "max_rel_vs_contiguous": worst,
         "greedy_agreement_untied": agree,
         "forced_paged_argmax_matches_run": same_p / n_tok,
         "forced_contiguous_argmax_matches_run": same_c / n_tok,
         "kv_plan": st.kv_plan, "decode_turns_ms": turns}
    log(f"serve main: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"vocab {cfg.vocab_size}), bf16, seeded weights ({weight_bytes} "
        f"bytes, built on the card in {init_s:.2f} s); {job['n_req']} "
        f"requests of {job['prompt']} tokens, {job['max_new']} new each, "
        f"paged decode, page {PAGE}")
    log(f"  prefill {st.prefill_tokens} tokens in {st.prefill_s:.3f} s "
        f"({m['prefill_tokens_per_s']:.1f} tokens/s); decode "
        f"{st.decode_tokens} steps in {st.decode_s:.3f} s "
        f"({m['decode_tokens_per_s']:.2f} tokens/s, "
        f"{m['ms_per_decode_step']:.3f} ms per step; contiguous decode "
        f"{m['contiguous_ms_per_decode_step']:.3f} ms per step)")
    log(f"  in turns (paged, contiguous, contiguous, paged; 32 steps "
        f"after the first prompt): paged "
        + ", ".join(f"{t:.3f}" for t in turns["paged"])
        + " ms per step, contiguous "
        + ", ".join(f"{t:.3f}" for t in turns["contiguous"])
        + f" (medians {statistics.median(turns['paged']):.3f} and "
        f"{statistics.median(turns['contiguous']):.3f})")
    log(f"  kernel launches {counts['launches']} (== {steps} steps x "
        f"{cfg.n_layers} layers), KV tokens read {counts['tokens']}, "
        f"max_memory_allocated {peak} bytes")
    log(f"  against the contiguous decode teacher-forced on the paged run's "
        f"tokens: max relative logit difference {worst:.3e} (limit "
        f"{SERVE_REL}); forced argmax reproduces the paged run on "
        f"{same_p}/{n_tok} tokens (paged) and {same_c}/{n_tok} "
        f"(contiguous); untied greedy runs agree on {agree:.4f} of tokens")
    return counts, m, model


def phase_serve_stablelm(dev) -> dict:
    """stablelm-3b (head_dim 80) at full width through run_server with the
    paged decode, every decode attention through the kernel, held against
    the contiguous decode teacher-forced on its tokens; both decodes run a
    2-token warm-up first, and the model is freed after."""
    cfg, job = STABLELM, SERVE_STABLELM
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(5, cfg, job)
    for paged in (True, False):   # first launches of this shape's kernels
        _serve(model, cfg, prompts, dict(job, max_new=2), paged)
    pops.reset_counts()
    toks, st = _serve(model, cfg, prompts, job, paged=True)
    counts = pops.counts()
    steps = job["n_req"] * (job["max_new"] - 1)
    if counts["launches"] != steps * cfg.n_layers or counts["plain_calls"]:
        raise AssertionError(f"serve stablelm: kernel counts {counts}; "
                             f"expected {steps} x {cfg.n_layers} launches")
    _, st_c = _serve(model, cfg, prompts, job, paged=False)
    worst = 0.0
    for p, t in zip(prompts, toks):
        if len(t) != job["max_new"] or min(t) < 0 or \
                max(t) >= cfg.vocab_size:
            raise AssertionError("serve stablelm: malformed outputs")
        lp = _forced_logits(model, cfg, p, t, True, job["max_seq"])
        lc = _forced_logits(model, cfg, p, t, False, job["max_seq"])
        if not bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()):
            raise AssertionError("serve stablelm: non-finite logits")
        worst = max(worst, float(_rel_per_step(lp, lc).max()))
    del model
    torch.cuda.empty_cache()
    if worst >= SERVE_REL:
        raise AssertionError(f"serve stablelm: paged logits differ from the "
                             f"contiguous decode's by relative {worst}")
    m = {"arch": cfg.name, "head_dim": cfg.head_dim, "init_s": init_s,
         "decode_tokens": st.decode_tokens,
         "ms_per_decode_step": st.decode_s / st.decode_tokens * 1e3,
         "contiguous_ms_per_decode_step":
             st_c.decode_s / st_c.decode_tokens * 1e3,
         "launches": counts["launches"],
         "combine_launches": counts["combine_launches"],
         "max_rel_vs_contiguous": worst}
    log(f"serve stablelm: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}), bf16, seeded weights (built in {init_s:.2f} s); "
        f"{job['n_req']} request of {job['prompt']} tokens, "
        f"{job['max_new']} new, paged decode: {counts['launches']} kernel "
        f"launches (== {steps} steps x {cfg.n_layers} layers), "
        f"{m['ms_per_decode_step']:.3f} ms per step (contiguous "
        f"{m['contiguous_ms_per_decode_step']:.3f}); against the contiguous "
        f"decode teacher-forced: max relative logit difference {worst:.3e} "
        f"(limit {SERVE_REL})")
    return m


# ---------------------------------------------------------------------------
# every model family: card against CPU at reduced size, then full widths
# ---------------------------------------------------------------------------


def _cache_leaves(tree) -> list:
    """The tensors of a cache tree (lists, tuples, dicts) in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in _cache_leaves(x)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def _caches_rel(got, want) -> tuple[float, int]:
    """Worst relative difference over two cache trees' float leaves, and
    the int8 entries and f16 scales that differ (each by at most one step
    or one ulp, or it raises): a card-vs-CPU difference in the last bits
    of K can round either way."""
    g, w = _cache_leaves(got), _cache_leaves(want)
    if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
        raise AssertionError("cache trees differ in structure")
    worst, flips = 0.0, 0
    for a, b in zip(g, w):
        if a.dtype in (torch.int8, torch.float16):
            # int8 payloads, f16 scales: compared as integers (f16 bits;
            # the scales are positive)
            if a.dtype == torch.float16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            d = (a.cpu().int() - b.int()).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"{a.dtype} caches differ by "
                                     f"{int(d.max())} steps")
            flips += int((d > 0).sum())
        else:
            worst = max(worst, _rel(a, b))
    return worst, flips


def _lm_parity(arch: str, kv: str, dev) -> dict:
    """A reduced family in f32, card against CPU: prefill logits and
    caches, three teacher-forced contiguous decode steps (logits, caches)
    and, unless int8, three paged steps through the kernel (logits; one
    launch an attention application and step)."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              kv_cache_dtype=kv)
    cpu_model = init_lm(cfg, 0, "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 23))
    plen, max_seq = 20, 24
    n_attn = sum(a.attn is not None for a in cpu_model.apps)
    out = {"logits": 0.0, "caches": 0.0, "int8_flips": 0, "paged": None}
    for paged in ((False, True) if kv != "int8" else (False,)):
        runs = {}
        for name, model in (("cpu", cpu_model), ("card", card_model)):
            d = model.device
            t = torch.as_tensor(toks, device=d)
            pops.reset_counts()
            with torch.inference_mode():
                lg, caches = lm_prefill(model, t[:, :plen], cfg,
                                        plen if paged else max_seq)
                rows, pre = [lg], [c.clone() for c in _cache_leaves(caches)]
                if paged:
                    caches, clen = paged_cache(cfg, caches, max_seq), None
                else:
                    clen = torch.full((2,), plen, device=d)
                for i in range(plen, plen + 3):
                    lg, caches = lm_decode(model, t[:, i:i + 1], caches,
                                           clen, cfg)
                    rows.append(lg)
                    if clen is not None:
                        clen = clen + 1
            runs[name] = (torch.cat(rows, 1), pre, caches, pops.counts())
        c = runs["card"][3]
        if c["plain_calls"] or c["launches"] != (3 * n_attn if paged else 0):
            raise AssertionError(f"parity {arch} paged={paged}: kernel "
                                 f"counts {c}")
        lrel = _rel(runs["card"][0], runs["cpu"][0])
        crel, flips = _caches_rel(runs["card"][1], runs["cpu"][1])
        if not paged:
            c2, f2 = _caches_rel(runs["card"][2], runs["cpu"][2])
            crel, flips = max(crel, c2), flips + f2
            out.update(logits=lrel, caches=crel, int8_flips=flips)
        else:
            out["paged"] = lrel
        if max(lrel, crel) >= PARITY_REL:
            raise AssertionError(f"parity {arch} {kv} paged={paged}: logits "
                                 f"{lrel}, caches {crel}")
    out["paged_launches"] = 3 * n_attn if kv != "int8" else 0
    return out


def _encdec_parity(dev) -> dict:
    """The reduced encoder-decoder in f32, card against CPU: encdec_prefill
    and four serve_step_encdec steps (logits, tokens, caches)."""
    cfg = dataclasses.replace(reduced_config("seamless-m4t-medium"),
                              dtype="float32")
    cpu_model = init_encdec(cfg, 0, "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(22)
    frames = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    runs = {}
    for name, model in (("cpu", cpu_model), ("card", card_model)):
        d = model.device
        f = torch.as_tensor(frames, device=d)
        t = torch.as_tensor(toks, device=d)
        with torch.inference_mode():
            rows = [encdec_prefill(model, f, t, cfg)]
            mem = encode(model, f, cfg)
            caches = encdec_init_caches(cfg, 2, 8, d)
            for i in range(4):
                _, caches, lg = serve_step_encdec(
                    model, t[:, i:i + 1], mem, caches,
                    torch.full((2,), i, device=d), cfg)
                rows.append(lg)
        runs[name] = (torch.cat(rows, 1), caches)
    lrel = _rel(runs["card"][0], runs["cpu"][0])
    crel, _ = _caches_rel(runs["card"][1], runs["cpu"][1])
    if max(lrel, crel) >= PARITY_REL:
        raise AssertionError(f"encdec parity: logits {lrel}, caches {crel}")
    return {"logits": lrel, "caches": crel}


def phase_families_parity(dev) -> dict:
    """Every family this slice serves at its reduced config in f32 on the
    card equals the same run on the CPU within relative 1e-4 (the CPU
    tests' tolerance): MoE (deepseek, phi3.5), the Mamba2 hybrid, xLSTM,
    chameleon's and seamless' ATTN stacks, qwen2 with the int8 KV cache,
    and the encoder-decoder's step."""
    out = {}
    for arch, kv in FAMILY_PARITY:
        out[f"{arch}:{kv}"] = r = _lm_parity(arch, kv, dev)
        log(f"families parity: reduced {arch} (kv {kv}) f32, card == CPU: "
            f"prefill + 3 contiguous steps logits within relative "
            f"{r['logits']:.3e}, caches {r['caches']:.3e} (int8 entries "
            f"or f16 scales one step apart: {r['int8_flips']}); paged "
            + (f"{r['paged']:.3e} over {r['paged_launches']} launches"
               if r["paged"] is not None else "refused (int8)"))
    out["encdec"] = r = _encdec_parity(dev)
    log(f"families parity: reduced seamless-m4t-medium encoder-decoder "
        f"f32, card == CPU: prefill + 4 serve_step_encdec logits within "
        f"{r['logits']:.3e}, caches {r['caches']:.3e}")
    return out


def _well_formed(tokens: list, cfg, n: int, what: str) -> None:
    if any(len(t) != n or min(t) < 0 or max(t) >= cfg.vocab_size
           for t in tokens):
        raise AssertionError(f"{what}: malformed outputs")


def _free() -> None:
    """Return the freed model's memory to the card before the next one."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class _Routing:
    """Records the experts each MoE call chooses (``models.blocks`` calls
    ``moe_mlp``; wrapped while the context is open): per call, each
    token's top-k set and the gap between its k-th and (k+1)-th router
    probabilities.  The wrapper recomputes the router's softmax as
    ``moe_mlp`` does and then calls it; it changes no result."""

    def __init__(self):
        from repro_torch.models import blocks
        self.blocks, self.calls = blocks, []

    def __enter__(self):
        inner = self.orig = self.blocks.moe_mlp

        def wrapped(p, x, cfg):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p.router, dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1)
            self.calls.append((top.indices[:, :-1].sort(-1).values.cpu(),
                               (top.values[:, -2] - top.values[:, -1])
                               .cpu()))
            return inner(p, x, cfg)
        self.blocks.moe_mlp = wrapped
        return self

    def __exit__(self, *exc):
        self.blocks.moe_mlp = self.orig


def _first_flip(a: list, b: list, per_step: int) -> tuple[int | None, float]:
    """The first decode step (0 = the prefill) at which two runs' routings
    differ, and the smallest top-k margin among the differing tokens;
    (None, inf) if they never differ."""
    for i, ((ia, ga), (ib, gb)) in enumerate(zip(a, b)):
        diff = (ia != ib).any(-1)
        if bool(diff.any()):
            return i // per_step, float(torch.minimum(ga, gb)[diff].min())
    return None, float("inf")


def _forced_pair(model, cfg, prompt, tokens, max_seq: int,
                 times: dict | None = None) -> tuple:
    """The paged and the contiguous decode teacher-forced on ``tokens``,
    with a model with experts their routings recorded: (paged logits,
    contiguous logits, the first step whose routings differ or None, the
    smallest top-k margin among its flipped tokens).  From a flip on the
    two decodes run other experts and write other K/V."""
    with _Routing() as rp:
        lp = _forced_logits(model, cfg, prompt, tokens, True, max_seq)
    with _Routing() as rc:
        lc = _forced_logits(model, cfg, prompt, tokens, False, max_seq,
                            times)
    if not bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    step, margin = _first_flip(rp.calls, rc.calls, cfg.n_layers) \
        if cfg.moe else (None, float("inf"))
    return lp, lc, step, margin


#: prompt tokens of the depth profile (bf16 against f32 block by block)
PROFILE_TOKENS = 16


def _block_states(model, cfg, prompt) -> list:
    """The residual stream after each block application of a prefill of
    the first PROFILE_TOKENS of ``prompt``, float32 on the host."""
    dev = model.device
    toks = torch.as_tensor(np.asarray(prompt[:PROFILE_TOKENS]),
                           device=dev)[None]
    out = []
    with torch.inference_mode():
        x = mlayers.embed(model.embed, toks)
        for app in model.apps:
            x, _ = model.block(app).prefill(x, toks.shape[1])
            out.append(x.float().cpu())
    return out


def _family_f32(cfg, dev, prompt, tokens, bf16: tuple,
                states: list) -> dict:
    """The model rebuilt in float32 at full width from the same seed (the
    bf16 weights are these rounded): its paged and contiguous decodes
    teacher-forced on the bf16 run's first request, held to each other
    within F32_REL before any routing flip; each bf16 decode's logits
    (``bf16``: paged, contiguous) against the f32 contiguous decode's, the
    rounding the bf16 model adds; and where it grows: the bf16 model's
    residual stream after each block (``states``) against the f32
    model's."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = init_lm(cfg32, 0, dev)
    lp, lc, step, margin = _forced_pair(model, cfg32, prompt, tokens,
                                        FAMILY_JOB["max_seq"])
    depth = [_rel(a, b) for a, b in zip(states,
                                        _block_states(model, cfg32, prompt))]
    del model
    _free()
    rel = _rel_per_step(lp, lc)[:step]
    out = {"f32_max_rel_vs_contiguous": float(rel.max()) if len(rel)
           else float("inf"),
           "f32_checked_steps": len(rel), "f32_flip": step,
           "bf16_paged_vs_f32": float(_rel_per_step(bf16[0], lc.cpu())
                                      .max()),
           "bf16_contiguous_vs_f32": float(_rel_per_step(bf16[1], lc.cpu())
                                           .max()),
           "bf16_vs_f32_by_block": depth}
    if out["f32_max_rel_vs_contiguous"] >= F32_REL or \
            len(rel) < len(tokens) // 2:
        raise AssertionError(f"{cfg.name} f32: paged logits differ from "
                             f"the contiguous decode's by relative "
                             f"{out['f32_max_rel_vs_contiguous']} over "
                             f"{len(rel)} steps (first flip {step}, margin "
                             f"{margin})")
    return out


def _family_lm(cfg, dev, seed: int, paged_check: bool) -> tuple[dict, dict]:
    """One decoder-only family at full width through run_server with the
    paged decode (its kernel counts read around that run), then, with
    ``paged_check``, the paged and contiguous decodes teacher-forced on its
    first request's tokens (in bf16, and in f32 in :func:`_family_f32`);
    without, the contiguous run_server of the first request (tokens
    equal: an attention-free model's paged decode runs the same ops).
    Frees the model; returns its metrics and the paged run's counts."""
    job = FAMILY_JOB
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_lm(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    n_attn = sum(a.attn is not None for a in model.apps)
    prompts = _prompts(seed, cfg, job)
    _serve(model, cfg, [prompts[0][:8]], dict(job, n_req=1, max_new=2),
           True)                                 # first calls of each op
    steps = job["n_req"] * (job["max_new"] - 1)
    pops.reset_counts()
    toks, st = _serve(model, cfg, prompts, job, paged=True)
    counts = pops.counts()
    if counts["launches"] != steps * n_attn or counts["plain_calls"]:
        raise AssertionError(f"{cfg.name}: kernel counts {counts}; expected "
                             f"{steps} steps x {n_attn} attention "
                             f"applications")
    _well_formed(toks, cfg, job["max_new"], cfg.name)
    m = {"arch": cfg.name, "params": sum(p.numel()
                                         for p in model.parameters()),
         "weight_bytes": weight_bytes, "init_s": init_s,
         "n_attn": n_attn, "head_dim": cfg.head_dim,
         "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
         "prefill_tokens_per_s": st.prefill_tokens / st.prefill_s,
         "ms_per_decode_step": st.decode_s / st.decode_tokens * 1e3,
         "launches": counts["launches"],
         "combine_launches": counts["combine_launches"]}
    if paged_check:
        # the first request teacher-forced through both decodes in bf16
        times = {}
        lp, lc, step, margin = _forced_pair(model, cfg, prompts[0], toks[0],
                                            job["max_seq"], times)
        rel = _rel_per_step(lp, lc)
        after = float(rel[step:].max()) if step is not None else 0.0
        rel = rel[:step]
        m.update(bf16_max_rel_vs_contiguous=float(rel.max()) if len(rel)
                 else 0.0, bf16_first_flip=step, bf16_flip_margin=margin,
                 bf16_max_rel_after_flip=after,
                 greedy_agreement=float((lc.argmax(-1) == torch.tensor(
                     toks[0], device=dev)).float().mean()),
                 contiguous_ms_per_decode_step=times["decode_s"]
                 / times["steps"] * 1e3)
        first = (lp.cpu(), lc.cpu())
        states = _block_states(model, cfg, prompts[0])
    else:
        # the first request again, contiguous: an attention-free model's
        # paged decode runs the same ops
        toks_c, st_c = _serve(model, cfg, prompts[:1], dict(job, n_req=1),
                              paged=False)
        if toks_c != toks[:1]:
            raise AssertionError(f"{cfg.name}: the paged run's tokens differ "
                                 f"from the contiguous run's")
        m.update(contiguous_ms_per_decode_step=st_c.decode_s
                 / st_c.decode_tokens * 1e3, max_rel_vs_contiguous=0.0,
                 greedy_agreement=1.0)
    m["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del model
    _free()
    if paged_check:
        m.update(_family_f32(cfg, dev, prompts[0], toks[0], first, states))
    log(f"serve families: {cfg.name} at full width ({m['params']} "
        f"parameters, {weight_bytes} bytes bf16, built on the card in "
        f"{init_s:.2f} s; {cfg.n_layers} layers, {n_attn} attention "
        f"applications of head_dim {cfg.head_dim}): {job['n_req']} requests "
        f"of {job['prompt']} + {job['max_new']} tokens; prefill "
        f"{m['prefill_tokens_per_s']:.1f} tokens/s, paged decode "
        f"{m['ms_per_decode_step']:.3f} ms a step (contiguous "
        f"{m['contiguous_ms_per_decode_step']:.3f}), paged calls "
        f"{counts['launches']} (== {steps} steps x {n_attn}); greedy "
        f"agreement with the contiguous decode {m['greedy_agreement']:.4f} "
        f"(first request);"
        f" max_memory_allocated {m['max_memory_allocated']} bytes")
    if paged_check:
        log(f"  teacher-forced, paged against contiguous: f32 model "
            f"{m['f32_max_rel_vs_contiguous']:.3e} over "
            f"{m['f32_checked_steps']} steps (limit {F32_REL}; first "
            f"routing flip {m['f32_flip']}); bf16 model "
            f"{m['bf16_max_rel_vs_contiguous']:.3e} before the first "
            f"routing flip (step {m['bf16_first_flip']}, smallest top-k "
            f"margin of a flipped token {m['bf16_flip_margin']:.3e}), "
            f"{m['bf16_max_rel_after_flip']:.3e} after; "
            f"against the f32 contiguous decode (first request): bf16 "
            f"paged {m['bf16_paged_vs_f32']:.3e}, bf16 contiguous "
            f"{m['bf16_contiguous_vs_f32']:.3e}")
        d = m["bf16_vs_f32_by_block"]
        marks = sorted({0, len(d) // 4, len(d) // 2, 3 * len(d) // 4,
                        len(d) - 1})
        log(f"  the bf16 residual stream against f32's after block "
            + ", ".join(f"{i + 1}: {d[i]:.3e}" for i in marks)
            + f" ({PROFILE_TOKENS}-token prefill)")
    return m, counts


def _family_encdec(dev) -> dict:
    """seamless-m4t-medium's encoder-decoder at full width: encdec_prefill
    of a 16-token prompt over 256 seeded frames, then the prompt a token at
    a time through serve_step_encdec from encdec_init_caches (its last
    step's logits held to the prefill's), then 16 greedy steps."""
    cfg, job = SEAMLESS, ENCDEC_JOB
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_encdec(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    b, plen, new = job["batch"], job["prompt"], job["max_new"]
    frames = torch.randn((b, job["frames"], cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (b, plen)), device=dev)
    pops.reset_counts()
    with torch.inference_mode():
        encdec_prefill(model, frames, toks[:, :2], cfg)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = encdec_prefill(model, frames, toks, cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        memory = encode(model, frames, cfg)
        caches = encdec_init_caches(cfg, b, plen + new, dev)
        t0 = time.perf_counter()
        for t in range(plen):
            nxt, caches, last = serve_step_encdec(
                model, toks[:, t:t + 1], memory, caches,
                torch.full((b,), t, device=dev), cfg)
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
        out = [nxt]
        t0 = time.perf_counter()
        for t in range(plen, plen + new - 1):
            nxt, caches, _ = serve_step_encdec(
                model, nxt, memory, caches, torch.full((b,), t, device=dev),
                cfg)
            out.append(nxt)
        gen_toks = torch.cat(out, 1).tolist()
        decode_s = time.perf_counter() - t0
    rel = float(_rel_per_step(last[:, -1], pre[:, -1]).max())
    _well_formed(gen_toks, cfg, new, cfg.name)
    if pops.counts()["launches"] or not bool(torch.isfinite(pre).all()):
        raise AssertionError("encdec: paged calls or non-finite logits")
    m = {"arch": cfg.name, "init_s": init_s,
         "params": sum(p.numel() for p in model.parameters()),
         "prefill_s": prefill_s, "prefill_tokens_per_s": b * plen / prefill_s,
         "prompt_feed_ms_per_step": feed_s / plen * 1e3,
         "ms_per_decode_step": decode_s / (new - 1) * 1e3,
         "rel_feed_vs_prefill": rel,
         "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    del model, memory, caches
    _free()
    if rel >= SERVE_REL:
        raise AssertionError(f"encdec: the fed prompt's last logits differ "
                             f"from encdec_prefill's by relative {rel}")
    log(f"serve families: {cfg.name} encoder-decoder at full width "
        f"({m['params']} parameters, built in {init_s:.2f} s; "
        f"{cfg.encoder_layers} + {cfg.n_layers} layers), batch {b}, "
        f"{job['frames']} frames: encdec_prefill of {plen} tokens "
        f"{m['prefill_tokens_per_s']:.1f} tokens/s; the prompt fed through "
        f"serve_step_encdec {m['prompt_feed_ms_per_step']:.3f} ms a step, "
        f"its last logits within relative {rel:.3e} of the prefill's (limit "
        f"{SERVE_REL}); {new} greedy steps {m['ms_per_decode_step']:.3f} ms "
        f"a step; max_memory_allocated {m['max_memory_allocated']} bytes")
    return m


def _kv_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for t in _cache_leaves(caches))


def _family_int8(model, dev) -> dict:
    """qwen2-1.5b with kv_cache_dtype="int8" (the same seeded weights as
    the bf16 model of the serve main phase) beside the bf16 KV cache,
    contiguous: the greedy share that agrees, the int8 decode's logits
    teacher-forced on the bf16 run's tokens against the bf16 decode's, the
    KV bytes of both."""
    cfg8 = dataclasses.replace(QWEN2, kv_cache_dtype="int8")
    job = INT8_JOB
    model8 = init_lm(cfg8, 0, dev)
    if not torch.equal(model8.blocks[-1].attn.wq, model.blocks[-1].attn.wq):
        raise AssertionError("int8: the seeded weights differ from bf16's")
    prompts = _prompts(9, QWEN2, job)
    toks_b, st_b = _serve(model, QWEN2, prompts, job, paged=False)
    pops.reset_counts()
    toks_8, st_8 = _serve(model8, cfg8, prompts, job, paged=False)
    if pops.counts()["launches"]:
        raise AssertionError("int8: paged calls on the contiguous path")
    _well_formed(toks_8, QWEN2, job["max_new"], "int8")
    agree = sum(a == b for x, y in zip(toks_b, toks_8)
                for a, b in zip(x, y)) / (job["n_req"] * job["max_new"])
    worst = 0.0
    for p, t in zip(prompts, toks_b):
        lb = _forced_logits(model, QWEN2, p, t, False, job["max_seq"])
        l8 = _forced_logits(model8, cfg8, p, t, False, job["max_seq"])
        if not bool(torch.isfinite(l8).all()):
            raise AssertionError("int8: non-finite logits")
        worst = max(worst, float(_rel_per_step(l8, lb).max()))
    with torch.inference_mode():
        tok = torch.as_tensor(prompts[0], device=dev)[None]
        kv_b = _kv_bytes(lm_prefill(model, tok, QWEN2, job["max_seq"])[1])
        kv_8 = _kv_bytes(lm_prefill(model8, tok, cfg8, job["max_seq"])[1])
    del model8
    _free()
    m = {"greedy_agreement": agree, "max_rel_vs_bf16": worst,
         "kv_bytes_bf16": kv_b, "kv_bytes_int8": kv_8,
         "max_seq": job["max_seq"],
         "ms_per_decode_step_bf16": st_b.decode_s / st_b.decode_tokens * 1e3,
         "ms_per_decode_step_int8": st_8.decode_s / st_8.decode_tokens * 1e3}
    log(f"serve families: qwen2-1.5b int8 KV cache beside bf16, "
        f"{job['n_req']} requests of {job['prompt']} + {job['max_new']} "
        f"tokens, contiguous: greedy agreement {agree:.4f}; int8 logits "
        f"teacher-forced on the bf16 tokens within relative {worst:.3e} of "
        f"bf16's; KV bytes at max_seq {job['max_seq']}: {kv_8} int8 against "
        f"{kv_b} bf16 ({kv_8 / kv_b:.4f}); decode "
        f"{m['ms_per_decode_step_int8']:.3f} ms a step int8, "
        f"{m['ms_per_decode_step_bf16']:.3f} bf16")
    return m


def _family_long(model, dev) -> tuple[dict, dict]:
    """qwen2-1.5b with one prompt of LONG_PROMPT tokens: the prefill
    through _sdpa_chunked (every layer, counted), one layer's chunked
    attention held to the dense formula in float32, then LONG_STEPS paged
    decode steps (counted) held to the contiguous decode teacher-forced on
    their tokens."""
    cfg = QWEN2
    plen, steps = LONG_PROMPT, LONG_STEPS
    max_seq = plen + steps + 1
    toks = torch.as_tensor(np.random.default_rng(24).integers(
        0, cfg.vocab_size, plen), device=dev)[None]
    calls = []
    chunked = mlayers._sdpa_chunked

    def counted(*a, **k):
        calls.append(a[0].shape[1])
        return chunked(*a, **k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mlayers._sdpa_chunked = counted
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, caches = lm_prefill(model, toks, cfg, max_seq)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
    finally:
        mlayers._sdpa_chunked = chunked
    peak = torch.cuda.max_memory_allocated(dev)
    if calls != [plen] * cfg.n_layers:
        raise AssertionError(f"long prompt: _sdpa_chunked calls {calls}")
    with torch.inference_mode():
        blk = model.blocks[0]
        h = mlayers.rmsnorm(blk.ln1, mlayers.embed(model.embed, toks),
                            cfg.norm_eps)
        pos = torch.arange(plen, device=dev)[None]
        q, k, v = (t.float() for t in mlayers._qkv(blk.attn, h, cfg, pos))
        a = mlayers._sdpa_chunked(q, k, v, cfg, 0)
        d = mlayers._sdpa_dense(q, k, v, cfg, 0)
        chunk_rel = _rel(a, d)
        del q, k, v, a, d, h
        k_all, v_all = caches[0]
        unpadded = [(k_all[:, :, :plen], v_all[:, :, :plen])]
        paged = paged_cache(cfg, unpadded, max_seq)
        del unpadded
        token = logits[:, -1].argmax(-1, keepdim=True)
        out, rows = [int(token[0, 0])], [logits[0, -1]]
        torch.cuda.synchronize()
        pops.reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            token, paged, lg = serve_step(model, token, paged, None, cfg)
            out.append(int(token[0, 0]))
            rows.append(lg[0, -1])
        decode_s = time.perf_counter() - t0
        counts = pops.counts()
        clen = torch.tensor([plen], device=dev)
        crow = [logits[0, -1]]
        for t in out[:-1]:
            lg, caches = lm_decode(model, torch.tensor([[t]], device=dev),
                                   caches, clen, cfg)
            clen = clen + 1
            crow.append(lg[0, -1])
    worst = float(_rel_per_step(torch.stack(rows), torch.stack(crow)).max())
    del caches, paged
    _free()
    if counts["launches"] != steps * cfg.n_layers or counts["plain_calls"]:
        raise AssertionError(f"long prompt: kernel counts {counts}")
    if chunk_rel > CHUNKED_REL or worst >= SERVE_REL:
        raise AssertionError(f"long prompt: chunked vs dense {chunk_rel}, "
                             f"paged vs contiguous {worst}")
    _well_formed([out], cfg, steps + 1, "long prompt")
    m = {"prompt": plen, "prefill_s": prefill_s,
         "prefill_tokens_per_s": plen / prefill_s,
         "max_memory_allocated": peak, "chunked_vs_dense_rel": chunk_rel,
         "ms_per_decode_step": decode_s / steps * 1e3,
         "launches": counts["launches"], "max_rel_vs_contiguous": worst}
    log(f"serve families: qwen2-1.5b, one prompt of {plen} tokens: prefill "
        f"through _sdpa_chunked ({len(calls)} layers) in {prefill_s:.3f} s "
        f"({m['prefill_tokens_per_s']:.1f} tokens/s), max_memory_allocated "
        f"{peak} bytes; layer 0's chunked attention against the dense "
        f"formula (f32): relative {chunk_rel:.3e} (limit {CHUNKED_REL}); "
        f"{steps} paged steps {m['ms_per_decode_step']:.3f} ms a step, "
        f"{counts['launches']} calls, within relative {worst:.3e} of the "
        f"contiguous decode (limit {SERVE_REL})")
    return m, counts


def phase_serve_families(dev, qwen2) -> tuple[dict, dict]:
    """deepseek-moe-16b, zamba2-7b, xlstm-1.3b and seamless-m4t-medium at
    their published widths and depth, each built on the card from a seed
    and freed before the next; qwen2-1.5b (``qwen2``, the serve main
    model) with the int8 KV cache and with a prompt of 8192 tokens.
    Returns the metrics and each paged path's kernel counts."""
    out, paths = {}, {}
    for cfg, seed, check in ((DEEPSEEK, 25, True), (ZAMBA2, 26, True),
                             (XLSTM, 27, False)):
        out[cfg.name], paths[cfg.name] = _family_lm(cfg, dev, seed, check)
    out[SEAMLESS.name] = _family_encdec(dev)
    out["qwen2-1.5b int8"] = _family_int8(qwen2, dev)
    out["qwen2-1.5b long"], paths["qwen2-1.5b long"] = \
        _family_long(qwen2, dev)
    log("serve families: not on the card: phi3.5-moe-42b-a6.6b (its "
        "experts alone are about 40.3e9 parameters, 81 GB in bf16: more "
        "than one H100 holds), chameleon-34b (68.6 GB, the qwen2 code path; "
        "both at reduced size in the families parity phase)")
    return out, paths


def _attn_timing(lens, dev, reps: int, cfg=QWEN2) -> dict:
    """The kernel, its plain version and gather + SDPA on ``cfg``'s heads
    (qwen2's by default) in bf16 at ``lens``; the bound from this input's
    work."""
    batch = len(lens)
    mp = -(-max(lens) // PAGE)
    qh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _attn_inputs(sum(lens), batch, qh, kvh, hd, PAGE, mp,
                     torch.bfloat16, dev, lens=lens)
    q, kp, vp, bt, sl = x
    err = _attn_check(x, f"lengths {list(lens)}")
    bt_d = torch.from_numpy(bt).to(dev).long().clamp(min=0)
    sl_d = torch.from_numpy(sl).to(dev)
    span = mp * PAGE
    mask = (torch.arange(span, device=dev)[None, :] < sl_d[:, None])[
        :, None, None, :]
    q4 = q.to(torch.bfloat16).view(batch, qh, 1, hd)

    def library():   # two calls: the gather, then SDPA
        k = kp[bt_d].view(batch, span, kvh, hd).transpose(1, 2)
        v = vp[bt_d].view(batch, span, kvh, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((library().float().view(batch, qh, hd)
                     - _attn_plain(*x)).abs().max())
    if lib_err > 2e-2:
        raise AssertionError(f"gather + SDPA differs from the plain version "
                             f"by {lib_err}")
    tables = _attn_tables(x)
    err = max(err, _attn_check(x, f"lengths {list(lens)}, prepared", tables))
    kfn = lambda: pops.paged_decode_attention(q, kp, vp,  # noqa: E731
                                              tables=tables)
    hfn = lambda: pops.paged_decode_attention(*x)  # noqa: E731
    pfn = lambda: _attn_plain(*x)  # noqa: E731
    parts = _call_kernels_ms(kfn, "paged_attn", reps)
    ms = sum(parts.values()) if parts else _device_ms(kfn, reps)
    nbytes = pk.work_bytes(sl, kvh, qh // kvh, hd, PAGE, 2)
    flops = pk.work_flops(sl, kvh, qh // kvh, hd)
    return {"ms": ms, "parts": parts or {},
            "chunk_pages": tables.chunk_pages, "chunks": tables.n_items,
            "host_ms": _device_ms(kfn, reps),
            "host_tables_ms": _device_ms(hfn, reps),
            "plain_ms": _device_ms(pfn, max(reps // 10, 3)),
            "library_ms": _device_ms(library, max(reps // 10, 3)),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOPS_PER_S * 1e3, "err": err}


def _attn_wrapper_costs(dev, reps: int = 2000) -> dict:
    """Host µs of the pieces of a paged-attention wrapper call at qwen2's
    heads, 230 tokens, batch 1 (the serve main path's shape), each on the
    host's clock: the tensor and card checks, the output and workspace
    allocation, the ctypes call alone (no items: it launches nothing), the
    whole call over prepared tables and over host tables; and, per decode
    step, preparing the tables, and per layer, the cache write the paged
    decode does before the call."""
    from repro_torch.kernels.paged_attn import kernel as pkern
    from repro_torch.serve.paged_kv import PagedKVCache, PagedKVConfig
    x = _attn_inputs(230, 1, QWEN2.n_heads, QWEN2.n_kv_heads,
                     QWEN2.head_dim, PAGE, 4, torch.bfloat16, dev,
                     lens=[230])
    q, kp, vp, bt, sl = x
    tables = _attn_tables(x)
    lib = pkern.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cache = PagedKVCache(PagedKVConfig(max_pages_per_seq=5), 5, 1,
                         QWEN2.n_kv_heads, QWEN2.head_dim, torch.bfloat16,
                         n_layers=2, device=dev)
    z = torch.zeros((2, 200, QWEN2.n_kv_heads, QWEN2.head_dim),
                    dtype=torch.bfloat16, device=dev)
    cache.write_prefill(0, z, z)
    step = cache.append_step()
    kv = z[0, :1]

    def outputs():
        torch.empty((1, 2, 6, 128), dtype=torch.float32, device=dev)
        torch.empty(tables.n_items * 2 * 6 * 130, dtype=torch.float32,
                    device=dev)

    def checks():
        pops._check_tensors(q, kp, vp)
        pops._check_prepared(tables, q, kp)
        pops._check_card(q, kp, vp)
    pieces = {
        "checks": checks,
        "outputs": outputs,
        "ctypes": lambda: lib.paged_attn_bf16(0, 0, 0, 0, 0, 0, 0, 0, 1, 2,
                                              6, 128, 64, 4, 0, 0, 0, 1.0,
                                              stream),
        "call": lambda: pops.paged_decode_attention(q, kp, vp,
                                                    tables=tables),
        "call_host_tables": lambda: pops.paged_decode_attention(*x),
        "prepare_tables": lambda: _attn_tables(x),
        "cache_write": lambda: cache.write(0, step, kv, kv),
    }
    return _host_us(pieces, reps)


#: each paged path of the serve families phase and the config whose heads
#: its calls take
FAMILY_PATHS = {"deepseek-moe-16b": DEEPSEEK, "zamba2-7b": ZAMBA2,
                "xlstm-1.3b": XLSTM, "qwen2-1.5b long": QWEN2}


def _attn_by_path(dev, paths: dict) -> dict:
    """Each serve families path's paged calls: its launches and, where it
    has any, the kernel timed at its shortest and longest lengths (equal
    weights), beside the bound and the plain version."""
    out = {}
    for name, counts in paths.items():
        sizes = sorted(counts["launch_sizes"])
        entry = {"launches": counts["launches"]}
        if sizes:
            pick = sorted({sizes[0], sizes[-1]})
            ones = [_attn_timing(list(lens), dev, 20, FAMILY_PATHS[name])
                    for lens in pick]
            mean = {k: statistics.fmean(o[k] for o in ones) for k in
                    ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
            entry.update(ms=mean["ms"], plain_ms=mean["plain_ms"],
                         library_ms=mean["library_ms"],
                         bound_ms=max(mean["bytes_ms"], mean["ops_ms"]),
                         head_dim=FAMILY_PATHS[name].head_dim,
                         lengths=[list(x) for x in pick],
                         err=max(o["err"] for o in ones))
            log(f"  paged_decode_attention on the {name} path "
                f"({counts['launches']} calls; heads "
                f"{FAMILY_PATHS[name].n_heads}/{FAMILY_PATHS[name].n_kv_heads}"
                f" of {FAMILY_PATHS[name].head_dim}) at lengths "
                f"{[x[0] for x in pick]}: {mean['ms']:.5f} ms per call (bound "
                f"{entry['bound_ms']:.3e} ms, plain {mean['plain_ms']:.4f} ms,"
                f" gather + SDPA {mean['library_ms']:.4f} ms)")
        out[name] = entry
    return out


def attn_record(dev, counts: dict, err: float,
                paths: dict | None = None) -> tuple[dict, dict]:
    """The kernels at every length of the serve main path, launch-weighted,
    and at the 32768-token batch: device time per call summed over the
    kernels it launches (split and combine also apart), the host's pace per
    call over prepared and over host tables (events, back to back); and
    each serve families path (``paths``: its counts) in ``by_path``."""
    sizes = counts["launch_sizes"]
    total = sum(sizes.values())
    keys = ("ms", "host_ms", "host_tables_ms", "plain_ms", "library_ms",
            "bytes_ms", "ops_ms")
    acc = dict.fromkeys(keys, 0.0)
    parts: dict = {}
    for lens, k in sizes.items():
        one = _attn_timing(list(lens), dev, 50)
        err = max(err, one["err"])
        for key in keys:
            acc[key] += k / total * one[key]
        for name, v in one["parts"].items():
            parts[name] = parts.get(name, 0.0) + k / total * v
    bound = max(acc["bytes_ms"], acc["ops_ms"])
    by = "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations"
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
           "replaces": "src/repro/kernels/paged_attn/kernel.py:29",
           "launches": counts["launches"], "max_abs_err": err,
           "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": bound,
           "bound_by": by, "library_ms": acc["library_ms"]}
    lens = np.random.default_rng(32).integers(1, LONG_LEN + 1, LONG_BATCH)
    lens[0] = LONG_LEN
    big = _attn_timing(lens.tolist(), dev, 10)
    row["max_abs_err"] = max(err, big["err"])
    b_big = max(big["bytes_ms"], big["ops_ms"])
    log(f"  paged_decode_attention over the serve main path's "
        f"{len(sizes)} lengths ({min(sizes)[0]}..{max(sizes)[0]} tokens, "
        f"batch 1, bf16, 1-page chunks): {acc['ms']:.5f} ms per call, the "
        f"sum of its kernels ("
        + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
        + f"; bound {bound:.3e} ms by {by}, {bound / acc['ms']:.3g} of it; "
        f"host {acc['host_ms']:.4f} ms per call over prepared tables, "
        f"{acc['host_tables_ms']:.4f} over host tables (events); plain "
        f"{acc['plain_ms']:.4f} ms; gather + SDPA, two calls, "
        f"{acc['library_ms']:.4f} ms)")
    log(f"  paged_decode_attention at batch {LONG_BATCH}, lengths up to "
        f"{LONG_LEN} ({int(lens.sum())} tokens, {big['chunks']} chunks of "
        f"{big['chunk_pages']} pages): {big['ms']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in big["parts"].items())
        + f"; bound {b_big:.4f} ms by bytes, {b_big / big['ms']:.3g} of it; "
        f"host {big['host_ms']:.4f} ms per call; plain "
        f"{big['plain_ms']:.3f} ms; gather + SDPA {big['library_ms']:.3f} "
        f"ms)")
    for name, ms in (("serve lengths", acc["ms"]), ("batch 8", big["ms"])):
        lib = acc["library_ms"] if name == "serve lengths" else \
            big["library_ms"]
        if ms >= lib:
            log(f"  NOTE: at the {name} the kernels ({ms:.5f} ms) are not "
                f"faster than gather + SDPA ({lib:.5f} ms)")
    by_path = {"serve main": {k: row[k] for k in ("launches", "ms",
                                                  "plain_ms", "bound_ms")}}
    by_path.update(_attn_by_path(dev, paths or {}))
    for entry in by_path.values():
        row["max_abs_err"] = max(row["max_abs_err"], entry.pop("err", 0.0))
    row["by_path"] = by_path
    costs = _attn_wrapper_costs(dev)
    log("  host µs per piece of a paged wrapper call at 230 tokens (host "
        "clock, back to back): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                            costs.items()))
    main = dict(acc, parts=parts, wrapper_us=costs)
    return row, {"serve_lengths": main,
                 "long": {k: big[k] for k in keys + ("parts", "chunk_pages",
                                                    "chunks")}}


def phase_serve_profile(dev, model) -> dict:
    """Eight decode steps of the serve main job (paged, after its 200-token
    prefill and two warm-up steps) under torch.profiler: device time by op
    and the busy share of their wall time (a lower bound on the unprofiled
    run's, since the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, job = QWEN2, SERVE_MAIN
    prompt = _prompts(0, cfg, job)[0]
    with torch.inference_mode():
        toks = torch.as_tensor(prompt, device=dev)[None]
        logits, caches = lm_prefill(model, toks, cfg, toks.shape[1])
        cache = paged_cache(cfg, caches, job["max_seq"])
        token = logits[:, -1].argmax(-1, keepdim=True)
        for _ in range(2):
            token, cache, _ = serve_step(model, token, cache, None, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                token, cache, _ = serve_step(model, token, cache, None, cfg)
                int(token[0, 0])
            wall_ms = (time.perf_counter() - t0) * 1e3
    evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in evs) / 1e3
    log(f"serve profile: 8 paged decode steps of {cfg.name}, {wall_ms:.1f} "
        f"ms under the profiler ({wall_ms / 8:.2f} ms per step), device "
        f"busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.3f} of it; idle share "
        f"{1 - busy_ms / wall_ms:.3f})")
    top = []
    for e in evs[:12]:
        log(f"  {_dev_us(e) / 1e3:10.3f} ms  {e.count:8d}x  {e.key[:70]}")
        top.append([e.key[:60], _dev_us(e) / 1e3, e.count])
    return {"steps": 8, "wall_ms": wall_ms, "busy_ms": busy_ms, "top": top}

# ---------------------------------------------------------------------------
# training: train parity, train, offload
# ---------------------------------------------------------------------------

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), at 700 W
BF16_FLOPS_PER_S = 989e12
#: the reduced configs trained card against CPU (train parity)
TRAIN_PARITY = ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-7b", "xlstm-1.3b",
                "seamless-m4t-medium"]
#: train parity's optimizer and the reduced loops' (tests/test_train_fault.py)
PARITY_OPT = OptConfig(peak_lr=1e-3, warmup_steps=2, stable_steps=2,
                       decay_steps=2)
REDUCED_TCFG = TrainConfig(microbatches=2, opt=OptConfig(
    peak_lr=1e-3, warmup_steps=2, stable_steps=10, decay_steps=4))
#: an entry whose gradient RMS is under this share of the largest moves by
#: a noise-driven amount under Adam (tests/test_torch_train_fault.py)
ADAM_NOISE = 1e-4
#: the full-width run: the reference launcher's defaults (batch 8 x seq
#: 128, 2 microbatches, its schedule for 8 steps)
TRAIN_STEPS = 8
TRAIN_DATA = DataConfig(seq_len=128, global_batch=8,
                        vocab_size=QWEN2.vocab_size)
TRAIN_TCFG = TrainConfig(microbatches=2, opt=OptConfig(
    peak_lr=1e-3, warmup_steps=5, stable_steps=max(TRAIN_STEPS - 10, 5),
    decay_steps=5))
#: the state reckoned from the config: bf16 params and grads, the f32
#: accumulator, f32 mu and nu
TRAIN_STATE_BYTES = 28.4e9
#: the pinned host<->device copy measured for est_overhead
COPY_BYTES = 256 << 20


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _adam_params_rel(want: dict, got: dict, nu: dict, lr: float
                     ) -> tuple[float, int]:
    """The worst relative error a leaf of the parameters on the entries
    whose gradient RMS (``want``'s sqrt(nu)) is at least ADAM_NOISE of the
    largest, and the count of the other entries, which must be within
    2 * lr (two Adam updates differ by at most that much)."""
    top = max(float(v.sqrt().max()) for v in nu.values())
    worst, noisy = 0.0, 0
    for name, w in want.items():
        w = w.detach().float().cpu()
        d = (w - got[name].detach().float().cpu()).abs()
        well = nu[name].cpu().sqrt() >= ADAM_NOISE * top
        if well.any():
            worst = max(worst, float(d[well].max() / w.abs().max()))
        noisy += int((~well).sum())
        if (~well).any() and float(d[~well].max()) > 2 * lr:
            raise AssertionError(f"train parity: {name} moved "
                                 f"{float(d[~well].max())} > 2 lr")
    return worst, noisy


def _train_parity(arch: str, dev) -> dict:
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    cpu_p, cpu_o = make_train_state(cfg, 0, "cpu")
    card_p, card_o = copy.deepcopy(cpu_p).to(dev), _to(cpu_o, dev)
    data = DataConfig(seq_len=17, global_batch=4, vocab_size=cfg.vocab_size,
                      frames_dim=cfg.d_model if cfg.is_encdec else 0)
    host = batch_for_step(data, 0)
    tcfg = TrainConfig(microbatches=2, opt=PARITY_OPT)
    runs = {}
    for name, p, o in (("cpu", cpu_p, cpu_o), ("card", card_p, card_o)):
        batch = {k: torch.as_tensor(v, device=p.embed.embed.device)
                 for k, v in host.items()}
        _, _, m = train_step(p, o, batch, cfg, tcfg)
        runs[name] = {k: float(v) for k, v in m.items()}
    out = {k: _rel(torch.tensor(runs["card"][k]), torch.tensor(runs["cpu"][k]))
           for k in ("loss", "grad_norm", "lr")}
    for part in ("mu", "nu"):
        out[part] = max(_rel(card_o[part][k], v)
                        for k, v in cpu_o[part].items())
    out["params"], out["noise_entries"] = _adam_params_rel(
        dict(cpu_p.named_parameters()), dict(card_p.named_parameters()),
        cpu_o["nu"], runs["cpu"]["lr"])
    out["loss_value"] = runs["card"]["loss"]
    if int(card_o["step"]) != 1 or max(
            v for k, v in out.items() if k in
            ("loss", "grad_norm", "lr", "mu", "nu", "params")) >= PARITY_REL:
        raise AssertionError(f"train parity {arch}: {out}")
    return out


def phase_train_parity(dev) -> dict:
    """One train step (2 microbatches, one batch_for_step batch) of each
    family's reduced config in f32 on the card and on the CPU from one
    seeded state: loss, grad_norm, lr, mu and nu within relative 1e-4 a
    leaf; the parameters too, but for entries whose gradient is at
    rounding noise (under ADAM_NOISE of the largest RMS), which must be
    within 2 lr."""
    out = {}
    for arch in TRAIN_PARITY:
        out[arch] = r = _train_parity(arch, dev)
        log(f"train parity: reduced {arch} f32, one step card == CPU: loss "
            f"{r['loss']:.3e}, grad_norm {r['grad_norm']:.3e}, lr "
            f"{r['lr']:.3e}, mu {r['mu']:.3e}, nu {r['nu']:.3e}, params "
            f"{r['params']:.3e} ({r['noise_entries']} noise-level entries "
            f"within 2 lr)")
    return out


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _step_flops(model, cfg, data: DataConfig) -> float:
    """The model FLOPs of one train step: 6 x (the parameters of every
    product: all but the input embedding's gather) x the positions
    trained, plus attention's two products over the whole (s, s) square
    as the port computes them, 3x for forward and backward; remat's
    recomputation not counted."""
    pos = data.global_batch * (data.seq_len - 1)
    dense = _n_params(model) - model.embed.embed.numel()
    attn = 12 * cfg.n_layers * data.global_batch * (data.seq_len - 1) ** 2 \
        * cfg.n_heads * cfg.head_dim
    return 6.0 * dense * pos + attn


def _train_profile(params, opt, dev, by_op: bool) -> dict:
    """One step timed in its two halves (CUDA events: the microbatches'
    forwards and backwards, then the optimizer), and one under
    torch.profiler: kernels, the busy share and device time by kernel;
    with ``by_op`` (``tools/train_phase.py``: the host's events take
    seconds to gather) one more step traced with the host's ops too,
    each ATen op's own kernels' device time."""
    from torch.profiler import ProfilerActivity, profile
    host = batch_for_step(TRAIN_DATA, TRAIN_STEPS)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    grads, _ = accumulate_grads(params, batch, QWEN2, TRAIN_TCFG)
    ev[1].record()
    adamw_update(TRAIN_TCFG.opt, params, grads, opt)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    fb_ms, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = train_step(params, opt, batch, QWEN2, TRAIN_TCFG)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in evs) / 1e3
    kernels = sum(e.count for e in evs if _dev_us(e))
    top = [[e.key[:60], _dev_us(e) / 1e3, e.count] for e in evs[:8]]
    if by_op:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, m = train_step(params, opt, batch, QWEN2, TRAIN_TCFG)
            float(m["loss"])
        ops = sorted((e for e in prof.key_averages()
                      if e.key.startswith("aten::")), key=_dev_us,
                     reverse=True)
        top = [[e.key, _dev_us(e) / 1e3, e.count] for e in ops[:12]]
    log(f"train profile: forward + backward {fb_ms:.2f} ms, optimizer "
        f"{opt_ms:.2f} ms (events); one step {wall_ms:.1f} ms under the "
        f"profiler, {kernels} kernels, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.3f}; idle share {1 - busy_ms / wall_ms:.3f});"
        f" device time by " + ("ATen op (its own kernels'):" if by_op
                               else "kernel:"))
    for key, ms, count in top:
        log(f"  {ms:10.3f} ms  {count:8d}x  {key}")
    return {"fwd_bwd_ms": fb_ms, "opt_ms": opt_ms, "wall_ms": wall_ms,
            "busy_ms": busy_ms, "kernels": kernels, "top": top}


def _train_full(dev, smi: str, by_op: bool) -> dict:
    """qwen2-1.5b at its published widths in bf16, seeded on the card: 8
    steps of train_loop (no checkpoint), then the profiled steps."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, opt = make_train_state(QWEN2, 0, dev)
    watch = {k: params.get_parameter(k).detach().clone() for k in
             ("blocks.0.attn.wq", "blocks.27.mlp.w_down", "final_norm.scale",
              "embed.lm_head")}
    report = train_loop(QWEN2, TRAIN_TCFG, TRAIN_DATA, FaultConfig(),
                        TRAIN_STEPS, ckpt_dir=None, log_every=TRAIN_STEPS,
                        device=dev, state=(params, opt))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    hist = report.history
    bad = [h for h in hist if not (np.isfinite(h["loss"])
                                   and np.isfinite(h["grad_norm"]))]
    changed = [k for k, v in watch.items()
               if not torch.equal(v, params.get_parameter(k))]
    if bad or len(hist) != TRAIN_STEPS or int(opt["step"]) != TRAIN_STEPS \
            or report.final_step != TRAIN_STEPS or len(changed) != len(watch):
        raise AssertionError(f"train: bad steps {bad}, {len(hist)} steps, "
                             f"opt step {int(opt['step'])}, changed "
                             f"{changed}")
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    tokens = TRAIN_DATA.global_batch * TRAIN_DATA.seq_len
    flops = _step_flops(params, QWEN2, TRAIN_DATA)
    out = {"params": _n_params(params), "steps": TRAIN_STEPS,
           "first_step_s": hist[0]["seconds"], "ms_per_step": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "losses": [h["loss"] for h in
                                                       hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "peak_bytes": peak, "state_bytes_reckoned": TRAIN_STATE_BYTES,
           "step_flops": flops,
           "bf16_peak_share": flops / (step_s * BF16_FLOPS_PER_S),
           "card": smi}
    log(f"train: {QWEN2.name} at full width ({out['params']:,} parameters, "
        f"bf16), batch {TRAIN_DATA.global_batch} x {TRAIN_DATA.seq_len}, "
        f"2 microbatches: {TRAIN_STEPS} steps, loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}, {out['ms_per_step']:.2f} ms a step "
        f"(median of steps 2-{TRAIN_STEPS}; first {hist[0]['seconds']:.2f} "
        f"s), {out['tokens_per_s']:.0f} tokens/s, peak {peak:,} B against "
        f"{TRAIN_STATE_BYTES:.3g} B of state reckoned, "
        f"{out['bf16_peak_share']:.4f} of the bf16 dense peak "
        f"({flops:.4g} FLOPs a step; {smi})")
    out["profile"] = _train_profile(params, opt, dev, by_op)
    del params, opt, watch
    _free()
    return out


def _state_close(a, b, what: str) -> None:
    for (ka, ta), (kb, tb) in zip(ckpt._flat(a).items(),
                                  ckpt._flat(b).items()):
        if ka != kb:
            raise AssertionError(f"{what}: {ka} != {kb}")
        np.testing.assert_allclose(ta.detach().float().cpu().numpy(),
                                   tb.detach().float().cpu().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=what + ka)


def _train_faults(dev) -> dict:
    """The reduced qwen2 loop on the card with checkpoints: 8 steps
    straight against 4 + resume + 4 (tests/test_train_fault.py's
    tolerance), and a NaN injected at step 5."""
    import tempfile
    cfg = reduced_config("qwen2-1.5b")
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    out = {}
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as tmp:
        d1, d2, d3 = (os.path.join(tmp, x) for x in "abc")
        t0 = time.perf_counter()
        fc = FaultConfig(checkpoint_every=4)
        r1 = train_loop(cfg, REDUCED_TCFG, data, fc, 8, ckpt_dir=d1,
                        log_every=100, device=dev)
        train_loop(cfg, REDUCED_TCFG, data, fc, 4, ckpt_dir=d2,
                   log_every=100, device=dev)
        r2 = train_loop(cfg, REDUCED_TCFG, data, fc, 8, ckpt_dir=d2,
                        log_every=100, device=dev)
        states = []
        for d in (d1, d2):
            p, o = make_train_state(cfg, 0, dev)
            ckpt.restore(d, 8, p, o)
            states.append((p, o))
        _state_close(states[0][0], states[1][0], "resume params ")
        _state_close(states[0][1], states[1][1], "resume opt ")
        if r1.final_step != 8 or r2.final_step != 8:
            raise AssertionError(f"resume: final steps {r1.final_step}, "
                                 f"{r2.final_step}")
        out["resume_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = train_loop(cfg, REDUCED_TCFG, data,
                       FaultConfig(checkpoint_every=3, max_rollbacks=2), 8,
                       ckpt_dir=d3, inject_nan_at=5, log_every=100,
                       device=dev)
        if r.rollbacks != 1 or r.final_step != 8:
            raise AssertionError(f"nan rollback: {r}")
        out.update(nan_s=time.perf_counter() - t0, rollbacks=r.rollbacks,
                   final_step=r.final_step, checkpoints=r.checkpoints,
                   step_ms=statistics.median(h["seconds"] for h in
                                             r1.history) * 1e3)
    log(f"train faults: reduced {cfg.name} on the card, 8 steps straight == "
        f"4 + resume + 4 (rtol 1e-5, atol 1e-6; {out['resume_s']:.2f} s), "
        f"NaN at step 5: {out['rollbacks']} rollback, final step "
        f"{out['final_step']} ({out['nan_s']:.2f} s); "
        f"{out['step_ms']:.2f} ms a reduced step")
    return out


def phase_train(dev, smi: str, by_op: bool = False) -> dict:
    return {"full": _train_full(dev, smi, by_op),
            "faults": _train_faults(dev)}


def _trace_ok(tr) -> None:
    """fx_trace's contract: every buffer read is an input (never written)
    or was written by an earlier instruction; every write a new buffer."""
    written = {b for w in tr.writes for b in w}
    seen = set()
    for i, (r, w) in enumerate(zip(tr.reads, tr.writes)):
        bad = [b for b in r if b in written and b not in seen]
        if bad or seen.intersection(w):
            raise AssertionError(f"offload trace: instruction {i} "
                                 f"({tr.names[i]}) reads {bad}")
        seen.update(w)
    ids = {b for x in tr.reads + tr.writes for b in x}
    if not ids <= set(range(len(tr.sizes))) or min(tr.sizes) < 0:
        raise AssertionError("offload trace: buffer ids or sizes out of "
                             "range")


def _copy_rate(dev) -> dict:
    """Pinned host <-> device copies of COPY_BYTES, CUDA events, the
    median of five each way."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        ms = []
        for _ in range(6):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        rates[name] = COPY_BYTES / (statistics.median(ms[1:]) / 1e3)
    del host, card
    return rates


def phase_offload(dev, model) -> dict:
    """fx_trace (fake mode) of the gradient of lm_loss for full-width
    qwen2-1.5b (``model``, the serve phases' seeded bf16 weights) at one
    microbatch of the train run (4 x 128) without remat; plan_offload
    unbounded and at half the peak; est_overhead at the pinned copy rate
    measured here; then the same gradient computed for real on the card,
    its allocator peak beside the plan's peak_unbounded (reported, not
    gated)."""
    cfg = QWEN2
    toks = torch.as_tensor(batch_for_step(TRAIN_DATA, 0)["tokens"][:4],
                           device=dev)
    fn, params = loss_grad(model, lambda m, t: lm_loss(m, t, cfg,
                                                       remat=False)[0])
    t0 = time.perf_counter()
    tr = fx_trace(fn, params, toks)
    trace_s = time.perf_counter() - t0
    _trace_ok(tr)
    t0 = time.perf_counter()
    unb = plan_offload(tr, 1 << 40)
    half = plan_offload(tr, unb.peak_unbounded // 2)
    plan_s = time.perf_counter() - t0
    if not (unb.feasible and half.feasible) or unb.bytes_out:
        raise AssertionError(f"offload: unbounded feasible {unb.feasible} "
                             f"(out {unb.bytes_out}), half "
                             f"{half.feasible}")
    rates = _copy_rate(dev)
    bw = min(rates.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = fn(params, toks)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    real_peak = torch.cuda.max_memory_allocated() - base + param_bytes + \
        toks.numel() * toks.element_size()
    if sorted(grads) != sorted(params) or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("offload: the real gradient is not finite")
    del grads
    _free()
    out = {"nodes": len(tr.reads), "buffers": len(tr.sizes),
           "trace_s": trace_s, "plan_s": plan_s,
           "peak_unbounded": unb.peak_unbounded,
           "half": {"budget": half.budget_bytes, "bytes_out": half.bytes_out,
                    "bytes_in": half.bytes_in, "offloads": half.n_offloads,
                    "reloads": half.n_reloads},
           "copy_bytes_per_s": rates, "est_overhead_s": half.est_overhead(bw),
           "est_overhead_s_at_50e9": half.est_overhead(),
           "param_bytes": param_bytes,
           "real_grad_s": grad_s, "real_peak_bytes": real_peak,
           "real_over_plan": real_peak / unb.peak_unbounded}
    log(f"offload: fx_trace of {cfg.name}'s lm_loss gradient at 4 x 128, no "
        f"remat: {out['nodes']} instructions, {out['buffers']} buffers in "
        f"{trace_s:.2f} s; plans in {plan_s:.2f} s: peak_unbounded "
        f"{unb.peak_unbounded:,} B; at half: out {half.bytes_out:,} / in "
        f"{half.bytes_in:,} B, {half.n_offloads} offloads / "
        f"{half.n_reloads} reloads; pinned copies h2d "
        f"{rates['h2d'] / 1e9:.2f} d2h {rates['d2h'] / 1e9:.2f} GB/s -> "
        f"est_overhead {out['est_overhead_s']:.4f} s "
        f"({out['est_overhead_s_at_50e9']:.4f} s at the reference's 50 GB/s);"
        f" the real gradient {grad_s:.3f} s, allocator peak {real_peak:,} B "
        f"(params and tokens included) = {out['real_over_plan']:.3f} of "
        f"peak_unbounded")
    return out



# ---------------------------------------------------------------------------
# distributed: sharded training on a world of one, the pipeline as two
# processes on the card, the dry run of full-width cells (host work)
# ---------------------------------------------------------------------------

#: sharded steps held against the unsharded ones (full-width qwen2-1.5b)
DIST_STEPS = 3
#: the reduced float32 gate: step 1's learning rate 1e-6, so Adam's
#: noise-level entries stay within 2e-6 (tests/_torch_dist.py)
DIST_GATE_OPT = OptConfig(peak_lr=1e-3, warmup_steps=1000)
DIST_GATE_TOL = 1e-5
#: the dry run's cells, in a process of its own started at the top (no
#: card): the reference's two integration cells, qwen2's train cell, and
#: the train phase's own cell on a (1, 1) mesh
DRYRUN_CELLS = (
    dict(arch="qwen2-1.5b", shape="decode_32k", multi_pod=False),
    dict(arch="stablelm-3b", shape="decode_32k", multi_pod=True),
    dict(arch="qwen2-1.5b", shape="train_4k", multi_pod=False),
    dict(arch="qwen2-1.5b", shape="train_4k", multi_pod=False,
         mesh_shape=(1, 1), seq_len=TRAIN_DATA.seq_len,
         global_batch=TRAIN_DATA.global_batch,
         microbatches=TRAIN_TCFG.microbatches),
)


def dryrun_cells() -> list[dict]:
    """``launch.dryrun.run_cell`` of each of DRYRUN_CELLS (a fake process
    group a cell, in this process: no card)."""
    from repro_torch.launch.dryrun import run_cell
    out = []
    for kw in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = run_cell(save=False, variant="chip", **kw)
        r["wall_s"] = time.perf_counter() - t0
        out.append(r)
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _sharded(params, opt, mesh, cfg):
    """The model's parameters as DTensors by params_shardings and the
    optimizer state in the ZeRO specs; returns (rules, ZeRO specs, opt)."""
    rules = rules_for(cfg, mesh)
    distribute_params(params, params_shardings(params, mesh, rules))
    zs = zero_pspecs(params, rules, mesh)
    return rules, zs, distribute_opt_state(opt, named_shardings(zs, mesh))


def _batch(host: dict, dev, mesh=None, rules=None) -> dict:
    out = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    if mesh is None:
        return out
    return {k: distribute(v, NamedSharding(
        mesh, P(rules.axis("batch"), *([None] * (v.ndim - 1)))))
        for k, v in out.items()}


def _train_steps(cfg, tcfg, data, steps: int, dev, mesh=None) -> dict:
    """``steps`` train steps from the seeded state, unsharded or (``mesh``)
    through the sharded path: losses, seconds a step, the final
    parameters and nu on the host."""
    params, opt = make_train_state(cfg, 0, dev)
    rules = zs = None
    if mesh is not None:
        rules, zs, opt = _sharded(params, opt, mesh, cfg)
    losses, secs = [], []
    for step in range(steps):
        batch = _batch(batch_for_step(data, step), dev, mesh, rules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (use_rules(rules) if mesh is not None
              else contextlib.nullcontext()):
            _, _, m = train_step(params, opt, batch, cfg, tcfg,
                                 grad_pspecs=zs)
        losses.append(float(_whole(m["loss"])))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = {"losses": losses, "secs": secs,
           "params": {n: _whole(p).detach().cpu()
                      for n, p in params.named_parameters()},
           "nu": {n: _whole(t).cpu() for n, t in opt["nu"].items()},
           "lr": float(_whole(m["lr"]))}
    del params, opt, m
    _free()
    return out


def _reduced_gate(dev, mesh) -> dict:
    """Reduced qwen2 in float32: one step's loss, gradients, mu, nu
    (relative) and parameters (absolute) sharded against unsharded, all
    within 1e-5."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32")
    tcfg = TrainConfig(microbatches=2, opt=DIST_GATE_OPT)
    data = DataConfig(seq_len=17, global_batch=8, vocab_size=cfg.vocab_size)
    host = batch_for_step(data, 0)
    plain, popt = make_train_state(cfg, 0, dev)
    model = copy.deepcopy(plain)
    want_g, want_m = accumulate_grads(plain, _batch(host, dev), cfg, tcfg)
    adamw_update(tcfg.opt, plain, want_g, popt)
    rules, zs, opt = _sharded(model, init_opt_state(model), mesh, cfg)
    with use_rules(rules):
        got_g, got_m = accumulate_grads(model, _batch(host, dev, mesh, rules),
                                        cfg, tcfg, grad_pspecs=zs)
        adamw_update(tcfg.opt, model, got_g, opt)
    out = {"loss": _rel(_whole(got_m["loss"]), want_m["loss"]),
           "grads": max(_rel(_whole(g), want_g[n]) for n, g in got_g.items())}
    for part in ("mu", "nu"):
        out[part] = max(_rel(_whole(t), popt[part][n])
                        for n, t in opt[part].items())
    want_p = dict(plain.named_parameters())
    out["params_abs"] = max(float((_whole(p) - want_p[n]).detach().abs()
                                  .max()) for n, p in model.named_parameters())
    if max(out.values()) > DIST_GATE_TOL:
        raise AssertionError(f"distributed: reduced f32 gate {out}")
    return out


def _pipeline_rank(rank: int, port: int) -> dict:
    """One of the pipeline's two processes on the card: reduced
    stablelm-3b at 4 layers in float32, 2 stages (gloo: activations and
    gradients staged through host memory), 2 microbatches, against
    lm_loss(aux_weight=0) and its autograd gradients on the card."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        cfg = dataclasses.replace(reduced_config("stablelm-3b"), n_layers=4,
                                  dtype="float32")
        model = init_lm(cfg, 0, dev).requires_grad_(True)
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 32)), dtype=torch.int32, device=dev)
        piped = copy.deepcopy(model)
        ref, _ = lm_loss(model, toks, cfg, aux_weight=0.0, remat=False)
        names = [n for n, _ in model.named_parameters()]
        want = dict(zip(names, torch.autograd.grad(ref, list(
            model.parameters()))))
        mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
        rules = rules_for(cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pipeline_loss(split_stage_params(piped, 2), toks, cfg, mesh,
                             n_micro=2, rules=rules)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stage = mesh.get_coordinate()[0]
        mine = [n for n, (s, _) in stage_param_specs(piped, 2, rules).items()
                if s in (None, stage)]
        got = dict(piped.named_parameters())
        return {"rank": rank, "stage": stage, "loss": float(loss),
                "ref": float(ref),
                "loss_rel": abs(float(loss) - float(ref)) / abs(float(ref)),
                "grads_rel": max(_rel(got[n].grad, want[n]) for n in mine),
                "params_checked": len(mine), "s": secs,
                "grad_device": str(got[mine[0]].grad.device)}
    finally:
        dist.destroy_process_group()


def _dist_sharded(dev, smi: str) -> dict:
    """(a): a world of one on the card (NCCL, a (1, 1) mesh)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        gate = _reduced_gate(dev, mesh)
        plain = _train_steps(QWEN2, TRAIN_TCFG, TRAIN_DATA, DIST_STEPS, dev)
        sharded = _train_steps(QWEN2, TRAIN_TCFG, TRAIN_DATA, DIST_STEPS, dev,
                               mesh)
    finally:
        dist.destroy_process_group()
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(sharded["losses"], plain["losses"]))
    params_rel, noisy = _adam_params_rel(plain["params"], sharded["params"],
                                         plain["nu"], plain["lr"])
    if loss_rel >= PARITY_REL or params_rel >= PARITY_REL:
        raise AssertionError(f"distributed: sharded != unsharded: loss "
                             f"{loss_rel}, params {params_rel}")
    ms = {k: statistics.median(r["secs"][1:]) * 1e3
          for k, r in (("unsharded", plain), ("sharded", sharded))}
    out = {"gate_f32": gate, "losses": sharded["losses"],
           "loss_rel": loss_rel, "params_rel": params_rel,
           "noise_entries": noisy, "ms_per_step": ms,
           "first_step_s": {"unsharded": plain["secs"][0],
                            "sharded": sharded["secs"][0]},
           "card": smi}
    log(f"distributed (a): world of one (NCCL, (1, 1) mesh); reduced qwen2 "
        f"f32 sharded == unsharded within 1e-5: {gate}; {QWEN2.name} at full "
        f"width, bf16, {DIST_STEPS} steps of batch {TRAIN_DATA.global_batch} "
        f"x {TRAIN_DATA.seq_len}, 2 microbatches, remat: losses "
        f"{sharded['losses']}, loss rel {loss_rel:.3e}, params rel "
        f"{params_rel:.3e} ({noisy} noise-level entries within 2 lr); "
        f"{ms['sharded']:.2f} ms a step sharded (DTensor parameters, ZeRO "
        f"state, grad_pspecs) against {ms['unsharded']:.2f} ms unsharded "
        f"(median of steps 2-{DIST_STEPS}; {smi})")
    return out


def _dist_pipeline() -> dict:
    """(b): the pipeline as two processes on the one card."""
    port = _free_port()
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        jobs = [pool.apply_async(_pipeline_rank, (r, port)) for r in (0, 1)]
        ranks = [j.get(timeout=600) for j in jobs]
    bad = [r for r in ranks if r["loss_rel"] > DIST_GATE_TOL
           or r["grads_rel"] > DIST_GATE_TOL]
    if bad:
        raise AssertionError(f"distributed: pipeline {bad}")
    log("distributed (b): pipeline_loss, reduced stablelm-3b at 4 layers in "
        "f32, 2 stages as two processes on the card (gloo; activations and "
        "gradients through host memory), 2 microbatches: " + "; ".join(
            f"rank {r['rank']} loss {r['loss']:.6f} (lm_loss "
            f"{r['ref']:.6f}, rel {r['loss_rel']:.2e}), grads rel "
            f"{r['grads_rel']:.2e} over {r['params_checked']} parameters "
            f"on {r['grad_device']}, {r['s']:.2f} s" for r in ranks))
    return {"ranks": ranks}


def _dist_dryrun(cells, ms_step: float) -> dict:
    """(c): the dry run's cells, computed meanwhile in a process of its
    own; the reference's assertions on qwen2-1.5b decode_32k."""
    out = []
    for kw, r in zip(DRYRUN_CELLS, cells):
        if not r["ok"]:
            raise AssertionError(f"distributed: dry run {kw}: "
                                 f"{r.get('error')}\n{r.get('traceback')}")
        roof, mem = r["roofline"], r["memory"]
        per_rank = mem["argument_bytes"] + mem["temp_bytes"]
        out.append({"cell": f"{r['arch']} {r['shape']} {r['mesh']}",
                    "per_rank_bytes": per_rank, "memory": mem,
                    "dominant": roof["dominant"],
                    "terms_s": [roof["compute_s"], roof["memory_s"],
                                roof["collective_s"]],
                    "bound_s": max(roof["compute_s"], roof["memory_s"],
                                   roof["collective_s"]),
                    "roofline_fraction": roof["roofline_fraction"],
                    "collectives": r["collectives"],
                    "counted_flops": r["roofline_hlo_raw"]["flops_per_chip"],
                    "build_s": r["lower_s"], "trace_s": r["compile_s"],
                    "wall_s": r["wall_s"]})
    first = out[0]
    if first["per_rank_bytes"] >= 80e9 or first["dominant"] != "memory":
        raise AssertionError(f"distributed: qwen2 decode_32k pod256 {first}")
    for c in out:
        log(f"distributed (c): dry run {c['cell']}: compute / memory / "
            f"collective {c['terms_s'][0]:.4g} / {c['terms_s'][1]:.4g} / "
            f"{c['terms_s'][2]:.4g} s (analytic, H100 constants; model "
            f"outputs, not device times), dominant {c['dominant']}, roofline "
            f"fraction {c['roofline_fraction']:.4f}; per rank "
            f"{c['per_rank_bytes']:,} B (arguments "
            f"{c['memory']['argument_bytes']:,}, temp "
            f"{c['memory']['temp_bytes']:,}); collectives "
            f"{c['collectives']}; counted FLOPs {c['counted_flops']:.4g}; "
            f"build {c['build_s']:.1f} s, trace {c['trace_s']:.1f} s")
    own = out[-1]
    log(f"distributed (c): the train phase's own cell on a (1, 1) mesh: "
        f"analytic bound {own['bound_s'] * 1e3:.3f} ms ({own['dominant']}) "
        f"against {ms_step:.2f} ms a sharded step measured in (a)")
    return {"cells": out}


def phase_distributed(dev, smi: str, cells) -> dict:
    a = _dist_sharded(dev, smi)
    b = _dist_pipeline()
    c = _dist_dryrun(cells.get(timeout=900), a["ms_per_step"]["sharded"])
    return {"sharded": a, "pipeline": b, "dryrun": c}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    # the plain versions' float32 products must run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        log(f"[{name}: {phases[name]:.2f} s]")
        return out

    # Fig. 8's streaming case, host work only, in a process of its own
    # until the streaming phase collects it
    case_pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(case_pool.terminate)      # also when a phase fails
    case = case_pool.apply_async(streaming_case)
    # the distributed phase's dry run cells (host work), likewise
    dry_pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(dry_pool.terminate)
    dry_cells = dry_pool.apply_async(dryrun_cells)
    # the baselines phase's CPU runs, likewise
    base_pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(base_pool.terminate)
    base_cpu = base_pool.apply_async(baseline_parity_cpu)
    # the parity job's CPU run, in a process of its own meanwhile
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu_parity = pool.apply_async(parity_cpu)
        smi = timed("device", phase_device)
        built = timed("build", phase_build)
        # the bench phase's host work, likewise (after the build, whose
        # nvcc processes it would slow)
        bench_pool = multiprocessing.get_context("spawn").Pool(1)
        atexit.register(bench_pool.terminate)
        bench = bench_pool.apply_async(bench_case)
        errs, big, gate_timing = timed("kernels", phase_kernels, dev)
        ntt_errs = timed("ntt kernels", phase_ntt_kernels, dev)
        attn_err = timed("attn kernels", phase_attn_kernels, dev)
        cpu_parity = cpu_parity.get()
    parity, parity_ref = timed("parity", phase_parity, dev, cpu_parity)
    ckks_parity = timed("ckks parity", phase_ckks_parity, dev)
    serve_parity = timed("serve parity", phase_serve_parity, dev)
    families_parity = timed("families parity", phase_families_parity, dev)
    counts, metrics, main_out = timed("main", phase_main, dev)
    ntt_counts, ckks_metrics, ckks_out = timed("ckks main", phase_ckks_main,
                                               dev)
    attn_counts, serve_metrics, model = timed("serve main", phase_serve_main,
                                              dev)
    stablelm = timed("serve stablelm", phase_serve_stablelm, dev)
    families, family_paths = timed("serve families", phase_serve_families,
                                   dev, model)
    train_parity = timed("train parity", phase_train_parity, dev)
    train = timed("train", phase_train, dev, smi)
    offload = timed("offload", phase_offload, dev, model)
    with dry_pool:
        distributed = timed("distributed", phase_distributed, dev, smi,
                            dry_cells)
    # after the serve phases, which so run in the process as they did
    # before the baselines existed
    with base_pool:
        baselines = timed("baselines", phase_baselines, dev, main_out,
                          metrics, base_cpu)
    del main_out
    gc_workloads, gc_counts, pir_counts = timed(
        "gc workloads", phase_gc_workloads, dev)
    workers, w_counts, w_ntt = timed("workers", phase_workers, dev)
    fleet, f_counts, f_ntt = timed("fleet", phase_fleet, dev, parity_ref,
                                   workers)
    with case_pool:
        streaming, s_counts, s_ntt = timed(
            "streaming", phase_streaming, dev, parity_ref,
            (ntt_counts, ckks_out), gc_workloads["jobs"],
            metrics["plan_digest"], case)
    del parity_ref, ckks_out
    shamir = timed("shamir", phase_shamir, dev)
    with bench_pool:
        bench = timed("bench", phase_bench, bench, baselines["gc_main"])
    daemon, d_paths = timed("serve daemon", phase_serve_daemon, dev)
    aggregate = timed("aggregate", phase_aggregate, dev)
    rows, gate_launch = timed("record", kernel_record, dev, {
        "gc main": counts, "gc workloads": gc_counts, "workers": w_counts,
        "fleet": f_counts, "streaming": s_counts,
        "serve daemon": d_paths["serve daemon"][0],
        "aggsum": d_paths["aggsum"][0]}, errs)
    ntt_rows, ntt_big = timed("ntt record", ntt_record, dev, {
        "ckks main": ntt_counts, "gc workloads": pir_counts,
        "workers": w_ntt, "fleet": f_ntt, "streaming": s_ntt,
        "serve daemon": d_paths["serve daemon"][1]}, ntt_errs)
    attn_row, attn_timing = timed("attn record", attn_record, dev,
                                  attn_counts, attn_err, family_paths)
    profiled = timed("profile", phase_profile, dev)
    ckks_profiled = timed("ckks profile", phase_ckks_profile, dev)
    serve_profiled = timed("serve profile", phase_serve_profile, dev, model)
    # the run's headline numbers, kept near the end of the output
    log("summary: " + json.dumps({
        "main": metrics, "m=2^20": big, "gates_build": built,
        "gates_timing": gate_timing, "gates_main_launch": gate_launch,
        "parity": parity,
        "profile": profiled, "ckks_main": ckks_metrics,
        "ntt_record": ntt_big, "ckks_parity": ckks_parity,
        "ckks_profile": ckks_profiled, "serve_main": serve_metrics,
        "serve_parity": serve_parity, "attn": attn_timing,
        "serve_stablelm": stablelm, "serve_families": families,
        "families_parity": families_parity,
        "train_parity": train_parity, "train": train, "offload": offload,
        "distributed": distributed,
        "serve_profile": serve_profiled, "baselines": baselines,
        "gc_workloads": gc_workloads, "workers": workers, "fleet": fleet,
        "streaming": streaming, "shamir": shamir,
        "serve_daemon": daemon, "aggregate": aggregate,
        "bench": {**{k: v for k, v in bench.items() if k != "rows"},
                  "rows": [[r["workload"], r["n"], r["unbounded_s"],
                            r["os_s"], r["mage_s"]] for r in bench["rows"]]},
        "phases_s": phases,
        "total_s": time.perf_counter() - t_all}))
    print(smi, flush=True)
    print(json.dumps({"kernels": rows + ntt_rows + [attn_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
