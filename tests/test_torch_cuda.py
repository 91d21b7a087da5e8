"""The port's CUDA kernels (half gates, NTT, modular product) against their
plain PyTorch versions, on the card, and small jobs on the card against
their CPU runs.  Kernels have no interpret mode, so these tests skip
without a card; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, which the card's machine may lack).
``chip_smoke.py`` runs the same checks at more sizes, and the job-level
ones.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import JobSpec, Session
from repro_torch.kernels.garble import ops, ref
from repro_torch.kernels.ntt import ops as nops
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
@pytest.mark.parametrize("m", [0, 1, 37, 4096])
def test_kernels_match_plain_all_rows(card, m):
    a, b, r, rt = _labels(np.random.default_rng(m), m, card)
    for gid0 in GIDS:
        ops.reset_counts()
        c, tab = ops.garble_and(a, b, r, gid0)
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(64, 3), (1024, 1), (1024, 12),
                                    (8192, 5)])
def test_ntt_kernels_match_plain(card, n, rows):
    """The three NTT kernels equal their plain versions bit for bit, every
    prime of a level and the special prime in one launch."""
    p = CkksParams(n_ring=n, levels=2)
    primes = p.primes + [p.special_prime]
    rng = np.random.default_rng(n + rows)
    a = _rns_rows(rng, primes, rows, n, card)
    b = _rns_rows(rng, primes, rows, n, card)
    nops.reset_counts()
    f = nops.ntt_forward(a, primes)
    inv = nops.ntt_inverse(f, primes)
    prod = nops.mul_mod(f, b, primes)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), nops.ntt_forward(a.cpu(), primes))
    assert torch.equal(inv, a)
    assert torch.equal(prod.cpu(), nops.mul_mod(f.cpu(), b.cpu(), primes))
    c = nops.counts()
    assert c["launches"] == {k: 1 for k in nops.KINDS}
    assert c["rows"] == {k: rows * len(primes) for k in nops.KINDS}


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
