"""The port's paged decode attention against the JAX package's: the plain
PyTorch version (which the CPU path runs and the card's kernel is held
against) against the Pallas kernel in interpret mode and the jnp oracle,
on inputs made from a seed with NumPy; the wrapper's CPU path, checks and
counters; the kernel's work figures.  The CUDA kernel itself has no
interpret mode: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
against the plain version on the card.

Tolerances are ``tests/test_kernels.py``'s: rtol 1e-4 / atol 1e-5 for f32
pages, 2e-2 for bf16 pages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import kernel as jkernel, ref as jref
from repro_torch.kernels.paged_attn import kernel as tkernel
from repro_torch.kernels.paged_attn import ops as tops, ref as tref

#: (batch, q_heads, kv_heads, head_dim, page_size, max_pages): the JAX
#: package's sweep (tests/test_kernels.py), then qwen2-1.5b's head shape
#: (12 query heads over 2 KV heads, head_dim 128, the 64-token page)
SWEEP = [(2, 8, 2, 64, 16, 4), (3, 4, 4, 32, 8, 3), (1, 16, 8, 128, 32, 2),
         (4, 2, 1, 64, 8, 5), (2, 12, 2, 128, 64, 3)]


def _inputs(batch, qh, kvh, hd, psz, mp, tails: bool, seed: int):
    rng = np.random.default_rng(seed)
    num_pages = batch * mp + 2
    q = rng.normal(0, 1, (batch, qh, hd)).astype(np.float32)
    kp = rng.normal(0, 1, (num_pages, psz, kvh, hd)).astype(np.float32)
    vp = rng.normal(0, 1, (num_pages, psz, kvh, hd)).astype(np.float32)
    bt = rng.permutation(num_pages)[:batch * mp].reshape(batch, mp) \
        .astype(np.int32)
    sl = rng.integers(1, mp * psz + 1, batch).astype(np.int32)
    if tails:   # pages past a sequence's length unallocated, as in serving
        bt[np.arange(mp)[None, :] >= -(-sl[:, None] // psz)] = -1
    return q, kp, vp, bt, sl


def _plain(q, kp, vp, bt, sl):
    return tref.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(sl)).numpy()


def _pallas(q, kp, vp, bt, sl):
    batch, qh, hd = q.shape
    kvh = kp.shape[2]
    out = jkernel.paged_decode_attention_pallas(
        jnp.asarray(q.reshape(batch, kvh, qh // kvh, hd)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(sl), interpret=True)
    return np.asarray(out).reshape(batch, qh, hd)


@pytest.mark.parametrize("tails", [False, True], ids=["full", "tails"])
@pytest.mark.parametrize("shape", SWEEP, ids=str)
def test_plain_matches_pallas_and_oracle(shape, tails):
    batch, qh = shape[:2]
    x = _inputs(*shape, tails=tails, seed=batch * 100 + qh)
    got = _plain(*x)
    np.testing.assert_allclose(got, _pallas(*x), rtol=1e-4, atol=1e-5)
    # the oracle gathers -1 entries as the last page; they are masked
    np.testing.assert_allclose(got, np.asarray(jref.paged_decode_attention(
        *x)), rtol=1e-4, atol=1e-5)


def test_single_query_ragged():
    rng = np.random.default_rng(7)
    qh, kvh, hd, psz = 4, 2, 32, 8
    q = rng.normal(0, 1, (1, qh, hd)).astype(np.float32)
    kp = rng.normal(0, 1, (2, psz, kvh, hd)).astype(np.float32)
    vp = rng.normal(0, 1, (2, psz, kvh, hd)).astype(np.float32)
    bt = np.array([[0, 1]], dtype=np.int32)
    sl = np.array([3], dtype=np.int32)   # ragged: mid-page sequence end
    got = _plain(q, kp, vp, bt, sl)
    np.testing.assert_allclose(got, _pallas(q, kp, vp, bt, sl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_decode_attention(q, kp, vp, bt, sl)),
        rtol=1e-4, atol=1e-5)


def test_bf16_pages():
    """bf16 pages in both packages: the port's plain version on the same
    bf16 values against the Pallas kernel on its bf16 pages (2e-2, as
    tests/test_kernels.py)."""
    rng = np.random.default_rng(0)
    batch, qh, kvh, hd, psz, mp = 2, 4, 2, 64, 16, 3
    num_pages = batch * mp
    q = rng.normal(0, 1, (batch, qh, hd)).astype(np.float32)
    kj = jnp.asarray(rng.normal(0, 1, (num_pages, psz, kvh, hd)),
                     dtype=jnp.bfloat16)
    vj = jnp.asarray(rng.normal(0, 1, (num_pages, psz, kvh, hd)),
                     dtype=jnp.bfloat16)
    bt = np.arange(num_pages).reshape(batch, mp).astype(np.int32)
    sl = np.full(batch, mp * psz, dtype=np.int32)
    want = np.asarray(jkernel.paged_decode_attention_pallas(
        jnp.asarray(q.reshape(batch, kvh, qh // kvh, hd)), kj, vj,
        jnp.asarray(bt), jnp.asarray(sl), interpret=True)).reshape(
        batch, qh, hd)

    def bf16(x):
        return torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(
            torch.bfloat16)
    got = tops.paged_decode_attention(torch.from_numpy(q), bf16(kj),
                                      bf16(vj), bt, sl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_cpu_wrapper_runs_plain_version_and_counts():
    x = _inputs(*SWEEP[-1], tails=True, seed=3)
    q, kp, vp, bt, sl = x
    tops.reset_counts()
    got = tops.paged_decode_attention(torch.from_numpy(q),
                                      torch.from_numpy(kp),
                                      torch.from_numpy(vp),
                                      torch.from_numpy(bt), sl)
    np.testing.assert_array_equal(got.numpy(), _plain(*x))
    assert tops.counts() == {"launches": 0, "tokens": 0, "plain_calls": 1,
                             "launch_sizes": {}}


@pytest.mark.parametrize("bad_len", [0, -1, 2 * 16 + 1])
def test_wrapper_rejects_lengths_out_of_range(bad_len):
    """A length of 0 has no answer (the Pallas kernel returns the mean of
    V, the oracle NaN); one past max_pages * page_size reads pages the
    table does not have."""
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=1)
    sl[1] = bad_len
    with pytest.raises(ValueError, match="seq_lens must lie"):
        tops.paged_decode_attention(torch.from_numpy(q),
                                    torch.from_numpy(kp),
                                    torch.from_numpy(vp), bt, sl)


def test_wrapper_rejects_bad_tables_and_tensors():
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=2)
    args = [torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp)]
    sl[:] = 17                        # both sequences use two pages
    bad = bt.copy()
    bad[0, 1] = -1
    with pytest.raises(ValueError, match="outside"):
        tops.paged_decode_attention(*args, bad, sl)
    bad[0, 1] = kp.shape[0]
    with pytest.raises(ValueError, match="outside"):
        tops.paged_decode_attention(*args, bad, sl)
    with pytest.raises(ValueError, match="integers"):
        tops.paged_decode_attention(*args, bt.astype(np.float32), sl)
    with pytest.raises(ValueError, match="do not fit"):
        tops.paged_decode_attention(*args, bt[:1], sl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.paged_decode_attention(args[0], args[1].half(), args[2].half(),
                                    bt, sl)
    with pytest.raises(ValueError, match="group"):
        tops.paged_decode_attention(args[0][:, :3], args[1], args[2], bt, sl)
    with pytest.raises(TypeError):
        tops.paged_decode_attention(q, args[1], args[2], bt, sl)


def test_wrapper_refuses_other_devices_and_card_shapes():
    """Host tables only (their values are checked before any pointer
    reaches the kernel); no kernel for other devices; the card's kernel
    takes head_dim a multiple of 32 up to 256 and aligned pages."""
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=4)
    args = [torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp)]
    with pytest.raises(ValueError, match="host data"):
        tops.paged_decode_attention(*args, torch.from_numpy(bt).to("meta"),
                                    sl)
    with pytest.raises(ValueError, match="no paged-attention kernel"):
        tops.paged_decode_attention(*(a.to("meta") for a in args), bt, sl)
    tops._check_card(*args)
    for hd in (48, 288):
        with pytest.raises(ValueError, match="multiple of 32"):
            tops._check_card(torch.zeros(1, 4, hd), torch.zeros(2, 8, 2, hd),
                             torch.zeros(2, 8, 2, hd))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tops._check_card(args[0], args[1], torch.zeros(
            args[2].numel() + 1)[1:].view(args[2].shape))


def test_work_figures():
    """Bytes: each token's K and V of every KV head once, q and out once,
    the used table entries and lengths once; flops: two products of group
    rows per key and an exp per score."""
    sl = [201, 64]
    nbytes = tkernel.work_bytes(sl, kv_heads=2, group=6, head_dim=128,
                                page_size=64, elem=2)
    assert nbytes == 265 * 2 * 128 * 2 * 2 + 2 * 2 * 2 * 6 * 128 * 4 + \
        4 * (4 + 1 + 2)
    assert tkernel.work_flops(sl, 2, 6, 128) == 265 * 2 * 6 * (4 * 128 + 1)
