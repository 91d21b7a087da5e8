"""The port's CUDA kernels (half gates, NTT, modular product, paged decode
attention) against their plain PyTorch versions, on the card, and small
jobs (a GC merge, CKKS jobs, unbounded jobs on both engine loops, jobs that
swap through the swap file, a reduced qwen2 served with the paged and the
contiguous decode) on the card against their CPU runs.  Kernels have no interpret mode, so these tests skip
without a card; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, which the card's machine may lack).
``chip_smoke.py`` runs the same checks at more sizes, and the job-level
ones.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.api import JobSpec, Session
from repro_torch.configs import reduced_config
from repro_torch.kernels.paged_attn import ops as pops, ref as pref
from repro_torch.launch.serve import run_server
from repro_torch.models import init_lm
from repro_torch.serve.serve_step import Request
from repro_torch.kernels.garble import ops, ref
from repro_torch.kernels.ntt import ops as nops
from repro_torch.protocols.ckks import cipher as ck
from repro_torch.protocols.ckks.params import CkksParams

GIDS = [0, (1 << 31) + 5, 1 << 40]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    return torch.device("cuda", 0)


def _labels(rng, m, dev):
    x = rng.integers(0, 1 << 64, (3, m, 2), dtype=np.uint64)
    a, b = (torch.from_numpy(x[i].view(np.int64)).to(dev) for i in (0, 1))
    r = x[2, 0] | np.uint64(1) if m else np.array([3, 5], np.uint64)
    return a, b, r, torch.from_numpy(r.view(np.int64).copy()).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0, 1, 16, 32, 37, 4096, 1 << 20])
def test_kernels_match_plain_all_rows(card, m):
    """The main path's 16- and 32-gate launches, odd tails, and 2^20 gates
    (where the garbler's two lanes fill many blocks), at 64-bit gate ids;
    the outputs are one allocation's two views."""
    a, b, r, rt = _labels(np.random.default_rng(m), m, card)
    for gid0 in GIDS:
        ops.reset_counts()
        c, tab = ops.garble_and(a, b, ops.offset(r), gid0)
        assert c.is_contiguous() and tab.is_contiguous()
        assert c.data_ptr() % 16 == 0 and tab.data_ptr() % 16 == 0
        assert c.data_ptr() + c.nbytes <= tab.data_ptr()
        if m:
            c_p, tab_p = ref.garble_and(a, b, rt, gid0)
            assert torch.equal(c, c_p) and torch.equal(tab, tab_p)
        for bit_a in (0, 1):
            for bit_b in (0, 1):
                wa, wb = a ^ (rt * bit_a), b ^ (rt * bit_b)
                w = ops.eval_and(wa, wb, tab, gid0)
                assert torch.equal(w, c ^ (rt * (bit_a & bit_b)))
                if m:
                    assert torch.equal(w, ref.eval_and(wa, wb, tab, gid0))
        n = ops.counts()
        assert n["garble_launches"] == (1 if m else 0)
        assert n["eval_launches"] == (4 if m else 0)


@pytest.mark.cuda
def test_small_job_on_card_matches_cpu(card):
    spec = JobSpec("merge", n=32, memory_budget=6, prefetch_pages=1)
    got = Session(spec, device=card)
    out = got.execute(real=True, check=True, digest=True)
    want = Session(spec, device="cpu")
    ref_out = want.execute(real=True, check=True, digest=True)
    assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
    assert got.table_digest == want.table_digest


def _rns_rows(rng, primes, rows, n, dev):
    """(rows, P, n) residues, row p of each stack below primes[p]."""
    q = np.asarray(primes, dtype=np.int64)[None, :, None]
    x = rng.integers(0, 1 << 62, (rows, len(primes), n)) % q
    return torch.from_numpy(x).to(dev)


#: (N, stacks, primes a stack): every prime of a level and the special
#: prime; the CKKS main path's launches of 3, 12 and 24 rows at N = 1024
#: (one prime, and the chain's three), N = 2, and 4096 rows
NTT_CASES = [(64, 3, 4), (1024, 1, 4), (1024, 12, 4), (8192, 5, 4),
             (1024, 3, 1), (1024, 12, 1), (1024, 24, 1), (1024, 1, 3),
             (1024, 4, 3), (1024, 8, 3), (2, 3, 1), (2, 5, 4),
             (1024, 4096, 1), (1024, 1024, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,n_primes", NTT_CASES,
                         ids=[f"{n}-{r}" if p == 4 else f"{n}-{r}x{p}"
                              for n, r, p in NTT_CASES])
def test_ntt_kernels_match_plain(card, n, rows, n_primes):
    """The four NTT kernels equal their plain versions bit for bit, one
    launch each, with ``rows`` stacks of ``n_primes`` primes in it (the
    fused one: the product of a and b); the fused launch adds the rows it
    transformed and multiplied to the standalone kinds' rows."""
    p = CkksParams(n_ring=n, levels=2)
    primes = (p.primes + [p.special_prime])[:n_primes]
    rng = np.random.default_rng(n + rows)
    a = _rns_rows(rng, primes, rows, n, card)
    b = _rns_rows(rng, primes, rows, n, card)
    nops.reset_counts()
    f = nops.ntt_forward(a, primes)
    inv = nops.ntt_inverse(f, primes)
    prod = nops.mul_mod(f, b, primes)
    fused = nops.ntt_mul([a, b], [], ck.ONE_TERM, primes)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), nops.ntt_forward(a.cpu(), primes))
    assert torch.equal(inv, a)
    assert torch.equal(prod.cpu(), nops.mul_mod(f.cpu(), b.cpu(), primes))
    assert torch.equal(fused.cpu(), nops.ntt_mul([a.cpu(), b.cpu()], [],
                                                 ck.ONE_TERM, primes))
    c = nops.counts()
    assert c["launches"] == {k: 1 for k in nops.KINDS}
    r = rows * len(primes)
    assert c["rows"] == {"ntt_forward": 3 * r, "ntt_inverse": 2 * r,
                         "mul_mod": 2 * r, "ntt_mul": r}


@pytest.mark.cuda
def test_ntt_refuses_misaligned_operand(card):
    """The transforms read two coefficients at a time, 16 bytes: an operand
    starting 8 bytes into its storage raises instead of reading
    misaligned."""
    q = CkksParams(n_ring=64, levels=2).primes[0]
    odd = torch.zeros(2 * 64 + 1, dtype=torch.int64, device=card)[1:]
    for fn in (nops.ntt_forward, nops.ntt_inverse):
        with pytest.raises(ValueError, match="16-byte"):
            fn(odd.view(2, 64), q)


#: fused jobs as the cipher makes them, (name, n, P, groups, n_coef,
#: n_ntt, terms): encrypt, decrypt of 3 components, the tensor product
#: of one and of 24 groups, relinearize, mul_plain; then sums and rings
#: beyond the main path's
MUL_CASES = [("encrypt", 1024, 3, 1, 1, 1, ck.ONE_TERM),
             ("decrypt3", 1024, 2, 1, 2, 2, ck.sum_terms(2)),
             ("tensor", 1024, 3, 1, 4, 0, ck.TENSOR_TERMS),
             ("tensor24", 1024, 3, 24, 4, 0, ck.TENSOR_TERMS),
             ("relin", 1024, 4, 1, 3, 6, ck.sum_terms(3, 2)),
             ("relin5", 1024, 4, 1, 5, 10, ck.sum_terms(5, 2)),
             ("plain", 1024, 3, 1, 3, 0, ck.plain_terms(2)),
             ("sum4", 1024, 4, 3, 8, 0,
              (tuple((s, 4 + s) for s in range(4)),)),
             ("runs", 1024, 1, 2, 8, 0,
              tuple(tuple((i, (i + o) % 8) for i in range(8))
                    for o in range(4))),
             ("ring2", 2, 4, 5, 2, 0, ck.ONE_TERM),
             ("ring64", 64, 4, 3, 2, 4, ck.sum_terms(2, 2)),
             ("ring4096", 4096, 2, 3, 3, 3, ck.plain_terms(2)),
             ("ring8192", 8192, 2, 3, 2, 4, ck.sum_terms(2, 2)),
             ("rows4096", 1024, 1, 4096, 2, 0, ck.ONE_TERM)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,n_primes,groups,n_coef,n_ntt,terms",
                         MUL_CASES, ids=[c[0] for c in MUL_CASES])
def test_ntt_mul_matches_cpu(card, name, n, n_primes, groups, n_coef, n_ntt,
                             terms):
    """The fused kernel equals its CPU run (the plain composition) bit for
    bit, the NTT-domain operands one stack broadcast over the groups as
    the secret's and the keys' rows are."""
    p = CkksParams(n_ring=n, levels=2)
    primes = tuple((p.primes + [p.special_prime])[:n_primes])
    rng = np.random.default_rng(n + groups + n_coef)
    coef = [_rns_rows(rng, primes, groups, n, card) for _ in range(n_coef)]
    ntt = [_rns_rows(rng, primes, 1, n, card)[0] for _ in range(n_ntt)]
    nops.reset_counts()
    got = nops.ntt_mul(coef, ntt, terms, primes)
    torch.cuda.synchronize()
    want = nops.ntt_mul([x.cpu() for x in coef], [x.cpu() for x in ntt],
                        terms, primes)
    assert torch.equal(got.cpu(), want)
    assert nops.counts()["launches"]["ntt_mul"] == 1


@pytest.mark.cuda
def test_relinearize_deep_level_matches_cpu(card):
    """relinearize at level 5 of a depth-5 chain (6 digits: two fused
    launches, summed) and level 4 (one launch) on the card equals its CPU
    run bit for bit, from the same keys."""
    p = CkksParams(n_ring=1024, levels=5)
    gpu = ck.CkksContext(p, seed=5, device=card)
    cpu = ck.CkksContext(p, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    nops.reset_counts()
    for lvl in (5, 4):
        q = np.asarray(p.level_primes(lvl), dtype=np.int64)[:, None]
        ct3 = torch.from_numpy(rng.integers(0, 1 << 40, (3, lvl + 1, 1024))
                               % q)
        got = gpu.relinearize(ct3.to(card), lvl)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), cpu.relinearize(ct3, lvl))
    assert nops.counts()["launches"]["ntt_mul"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("teams", [1, 2, 3, 4, 8])
def test_ntt_mul_any_cluster_matches_cpu(card, teams):
    """Clusters of 1 to 8 CTAs, reached through the job's shape (a CTA a
    row of the larger of the coefficient operands and the outputs): 5
    groups of ``teams`` coefficient rows at the chain's three primes, up
    to 4 outputs, each a sum over every row in its own order, so that each
    CTA takes the rows i with i % teams == its rank and reads the others
    from the CTAs that hold them."""
    p = CkksParams(n_ring=1024, levels=2)
    primes = tuple(p.primes)
    rng = np.random.default_rng(teams)
    q = np.asarray(primes, dtype=np.int64)[:, None]
    x = torch.from_numpy(rng.integers(0, 1 << 62, (5, teams, 3, 1024)) % q)
    terms = tuple(tuple((i, (i + o) % teams) for i in range(teams))
                  for o in range(min(teams, 4)))
    got = nops.ntt_mul(x.to(card), None, terms, primes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), nops.ntt_mul(x, None, terms, primes))


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,broadcast", [(1024, 2, False),
                                              (1024, 24, False),
                                              (1024, 4096, False),
                                              (64, 7, False), (2, 5, False),
                                              (8192, 3, False),
                                              (1024, 6, True)])
def test_mul_mod_matches_cpu(card, n, rows, broadcast):
    """The standalone product (16-byte rows, a prime a row) equals its CPU
    run bit for bit, with b a row per row of a or one stack for all."""
    p = CkksParams(n_ring=n, levels=2)
    primes = p.primes + [p.special_prime]
    rng = np.random.default_rng(n + rows)
    a = _rns_rows(rng, primes, rows, n, card)
    b = _rns_rows(rng, primes, 1 if broadcast else rows, n, card)
    if broadcast:
        b = b[0]
    got = nops.mul_mod(a, b, primes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), nops.mul_mod(a.cpu(), b.cpu(), primes))


@pytest.mark.cuda
def test_ntt_mul_refuses_misaligned_operand(card):
    q = CkksParams(n_ring=64, levels=2).primes[0]
    odd = torch.zeros(2 * 64 + 1, dtype=torch.int64, device=card)[1:]
    good = torch.zeros((2, 64), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        nops.ntt_mul(odd.view(2, 64), None, ck.ONE_TERM, q)
    with pytest.raises(ValueError, match="16-byte"):
        nops.mul_mod(odd.view(2, 64), good, q)


@pytest.mark.cuda
def test_small_ckks_job_on_card_matches_cpu(card):
    spec = JobSpec("rmvmul", n=4, memory_budget=3, prefetch_pages=1)
    got = Session(spec, device=card)
    nops.reset_counts()
    out = got.execute(check=True)
    c = nops.counts()
    ref_out = Session(spec, device="cpu").execute(check=True)
    assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
    assert got.engine_stats[0].swap_ins > 0
    assert c["rows"] == {k: got.ckks_counts[k] for k in nops.KINDS}
    assert sum(c["plain_calls"].values()) == 0


#: swap-file jobs at ring 128: prefetched reads, a bypassed read (the
#: page served from its pending write's prefetch slot) and sync swaps
MEMMAP_CARD = [("rmvmul", dict(n=4, memory_budget=3, prefetch_pages=1)),
               ("rmvmul", dict(n=4, memory_budget=3, prefetch_pages=1,
                               swap_bypass=True)),
               ("rstats", dict(n=8, memory_budget=3, prefetch_pages=0))]


@pytest.mark.cuda
@pytest.mark.parametrize("wl,job", MEMMAP_CARD,
                         ids=["prefetch", "bypass", "sync"])
def test_memmap_swaps_on_card(card, wl, job):
    """The swap file's card path (device pages through pinned bounce pages
    to the file and back) equals pinned storage on the card and the CPU
    run, engine memory bit for bit; the file is gone afterwards."""
    runs = [Session(JobSpec(wl, storage=st, **job), device=d)
            for st, d in (("memmap", card), ("ram", card), ("memmap", "cpu"))]
    outs = [s.execute(check=True) for s in runs]
    for s, out in zip(runs[1:], outs[1:]):
        assert all(np.array_equal(outs[0][k], out[k]) for k in out)
        assert torch.equal(runs[0].engines[0].memory.cpu(),
                           s.engines[0].memory.cpu())
    swaps = [(e.swap_ins, e.swap_outs, e.io_read_bytes, e.io_write_bytes)
             for e in (s.engine_stats[0] for s in runs)]
    assert swaps[0] == swaps[1] == swaps[2] and swaps[0][1] > 0
    assert not os.path.exists(runs[0].storages[0].path)


@pytest.mark.cuda
def test_unbounded_on_card_matches_cpu(card):
    """Unbounded jobs (the whole virtual address space on the card) on
    both backends equal their CPU runs: a GC merge's outputs and garbled
    tables, a CKKS job's outputs and final engine memory."""
    for backend in ("batched", "scalar"):
        spec = JobSpec("merge", n=32, plan_mode="unbounded",
                       exec_backend=backend)
        got, want = Session(spec, device=card), Session(spec, device="cpu")
        out = got.execute(real=True, check=True, digest=True)
        ref_out = want.execute(real=True, check=True, digest=True)
        assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
        assert got.table_digest == want.table_digest
        assert got.engine_stats[0].swap_ins == 0
        spec = JobSpec("rmvmul", n=4, plan_mode="unbounded",
                       exec_backend=backend)
        got, want = Session(spec, device=card), Session(spec, device="cpu")
        out = got.execute(check=True)
        ref_out = want.execute(check=True)
        assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
        assert torch.equal(got.engines[0].memory.cpu(),
                           want.engines[0].memory)
        assert got.engines[0].memory.shape[0] == got.plan()[0].vspace_slots


#: (batch, q_heads, kv_heads, head_dim, page_size, max_pages): shapes of
#: the JAX package's paged-attention tests, then qwen2's head shape, then
#: stablelm-3b's (32 query heads over 32 KV heads of 80), then a group of
#: 16 (two n-tiles of the kernel)
PAGED = [(2, 8, 2, 64, 16, 4), (3, 4, 4, 32, 8, 3), (1, 16, 8, 128, 32, 2),
         (4, 2, 1, 64, 8, 5), (3, 12, 2, 128, 64, 5), (2, 32, 32, 80, 64, 3),
         (2, 32, 2, 64, 16, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PAGED, ids=str)
def test_paged_attention_matches_plain(card, shape, dtype):
    """The kernel against its plain version on the same inputs (permuted
    pages, ragged lengths, -1 block-table tails), both K/V types; f32
    tolerance, since both sides compute in f32 from the same values."""
    batch, qh, kvh, hd, psz, mp = shape
    rng = np.random.default_rng(batch * 100 + qh)
    num_pages = batch * mp + 2
    q = torch.from_numpy(rng.normal(0, 1, (batch, qh, hd))).float()
    kp = torch.from_numpy(rng.normal(0, 1, (num_pages, psz, kvh, hd))
                          ).to(dtype)
    vp = torch.from_numpy(rng.normal(0, 1, (num_pages, psz, kvh, hd))
                          ).to(dtype)
    sl = rng.integers(1, mp * psz + 1, batch).astype(np.int32)
    bt = rng.permutation(num_pages)[:batch * mp].reshape(batch, mp) \
        .astype(np.int32)
    bt[np.arange(mp)[None, :] >= -(-sl[:, None] // psz)] = -1
    pops.reset_counts()
    got = pops.paged_decode_attention(q.to(card), kp.to(card), vp.to(card),
                                      bt, sl)
    torch.cuda.synchronize()
    want = pref.paged_decode_attention(q, kp, vp, torch.from_numpy(bt),
                                       torch.from_numpy(sl))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert pops.counts()["launches"] == 1
    assert pops.counts()["tokens"] == int(sl.sum())


#: lengths at the kernel's edges: one token, either side of a 64-token
#: page (and of a 64-token tile of four warps), a 2-page chunk exactly and
#: plus one, and the repo's decode_32k context
EDGES = [1, 63, 64, 65, 128, 129, 32768]


@pytest.mark.cuda
@pytest.mark.parametrize("prepared", [False, True], ids=["host", "prepared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(12, 2, 128), (32, 32, 80)],
                         ids=["qwen2", "stablelm"])
@pytest.mark.parametrize("length", EDGES)
def test_paged_attention_edges(card, length, heads, dtype, prepared):
    """The kernel against its plain version at the edge lengths (a second
    sequence one token longer, within the table), over host tables or
    over tables prepared with 2-page chunks (so 128 and 129 end a chunk
    and start one)."""
    qh, kvh, hd = heads
    if length == 32768 and kvh == 32:
        length = 8192      # 32 KV heads: keep the plain version's gather
    lens = np.array([length, min(length + 1, 32768)], dtype=np.int32)
    mp = -(-int(lens.max()) // 64)
    rng = np.random.default_rng(length + qh)
    num_pages = 2 * mp + 1
    gen = torch.Generator(device=card).manual_seed(length)
    q = torch.randn((2, qh, hd), generator=gen, device=card)
    kp = torch.randn((num_pages, 64, kvh, hd), generator=gen,
                     device=card).to(dtype)
    vp = torch.randn((num_pages, 64, kvh, hd), generator=gen,
                     device=card).to(dtype)
    bt = rng.permutation(num_pages)[:2 * mp].reshape(2, mp).astype(np.int32)
    bt[np.arange(mp)[None, :] >= -(-lens[:, None] // 64)] = -1
    pops.reset_counts()
    if prepared:
        t = pops.prepare_tables(bt, lens, page_size=64, num_pages=num_pages,
                                kv_heads=kvh, device=card, chunk_pages=2)
        got = pops.paged_decode_attention(q, kp, vp, tables=t)
    else:
        got = pops.paged_decode_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    want = pref.paged_decode_attention(q, kp, vp,
                                       torch.from_numpy(bt).to(card),
                                       torch.from_numpy(lens).to(card))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    c = pops.counts()
    assert c["launches"] == 1 and c["tokens"] == int(lens.sum())
    if prepared:
        assert c["combine_launches"] == int(mp > 2)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_reduced_serve_on_card_matches_cpu(card, paged):
    """Reduced qwen2 in f32 with nonzero biases: the card's greedy tokens
    equal the CPU run's, every decode attention of the paged run through
    the kernel."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32")
    model = init_lm(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    for blk in model.blocks:
        for name in ("q_bias", "k_bias", "v_bias"):
            b = getattr(blk.attn, name)
            b.copy_(torch.randn(b.shape, generator=g) * 0.5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 70) for _ in range(3)]

    def serve(params):
        reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
        run_server(cfg, reqs, 2, 79, paged=paged, params=params)
        return [r.output for r in reqs]

    want = serve(model)
    pops.reset_counts()
    got = serve(model.to(card))
    assert got == want
    assert pops.counts()["launches"] == (3 * 7 * cfg.n_layers if paged
                                         else 0)
    assert pops.counts()["plain_calls"] == 0
