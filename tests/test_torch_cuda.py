"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Kernels have no interpret mode, so these tests skip without a card;
run them there with

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
