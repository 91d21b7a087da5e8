"""The port's paged decode attention against the JAX package's: the plain
PyTorch version (which the CPU path runs and the card's kernel is held
against) and the split plain version (the same function divided into
chunks of pages and combined, as the card's kernels divide it) against the
Pallas kernel in interpret mode and the jnp oracle, on inputs made from a
seed with NumPy; the split plan; the wrapper's CPU path over host and
prepared tables, its checks and counters; the kernel's work figures.  The CUDA kernel itself has no
interpret mode: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
against the plain version on the card.

Tolerances are ``tests/test_kernels.py``'s: rtol 1e-4 / atol 1e-5 for f32
pages, 2e-2 for bf16 pages.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import kernel as jkernel, ref as jref
from repro_torch.kernels.paged_attn import kernel as tkernel
from repro_torch.kernels.paged_attn import ops as tops, ref as tref

#: (batch, q_heads, kv_heads, head_dim, page_size, max_pages): the JAX
#: package's sweep (tests/test_kernels.py), then qwen2-1.5b's head shape
#: (12 query heads over 2 KV heads, head_dim 128, the 64-token page), then
#: stablelm-3b's head_dim of 80 with a group of 1 (its 32 query heads over
#: 32 KV heads, cut to 4)
SWEEP = [(2, 8, 2, 64, 16, 4), (3, 4, 4, 32, 8, 3), (1, 16, 8, 128, 32, 2),
         (4, 2, 1, 64, 8, 5), (2, 12, 2, 128, 64, 3), (2, 4, 4, 80, 16, 3)]


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
    assert tops.counts() == {"launches": 0, "combine_launches": 0,
                             "tokens": 0, "plain_calls": 1,
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
    takes head_dim a multiple of 16 up to 256, up to 16 query heads per KV
    head and aligned pages."""
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=4)
    args = [torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp)]
    with pytest.raises(ValueError, match="host data"):
        tops.paged_decode_attention(*args, torch.from_numpy(bt).to("meta"),
                                    sl)
    with pytest.raises(ValueError, match="no paged-attention kernel"):
        tops.paged_decode_attention(*(a.to("meta") for a in args), bt, sl)
    tops._check_card(*args)
    for hd in (40, 288):
        with pytest.raises(ValueError, match="multiple of 16"):
            tops._check_card(torch.zeros(1, 4, hd), torch.zeros(2, 8, 2, hd),
                             torch.zeros(2, 8, 2, hd))
    for hd in (48, 80):       # 80: stablelm-3b's head_dim
        tops._check_card(torch.zeros(1, 4, hd), torch.zeros(2, 8, 2, hd),
                         torch.zeros(2, 8, 2, hd))
    tops._check_card(torch.zeros(1, 32, 64), torch.zeros(2, 8, 2, 64),
                     torch.zeros(2, 8, 2, 64))
    with pytest.raises(ValueError, match="query heads per KV head"):
        tops._check_card(torch.zeros(1, 34, 64), torch.zeros(2, 8, 2, 64),
                         torch.zeros(2, 8, 2, 64))
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


# ---------------------------------------------------------------------------
# the split: per-chunk partials and their combination, the plan, and the
# wrapper over prepared tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _split_case(shape, tails: bool):
    """Inputs (tuples of arrays) and the Pallas kernel's output, once per
    case for every chunk size."""
    batch, qh = shape[:2]
    x = _inputs(*shape, tails=tails, seed=batch * 100 + qh + 7)
    return x, _pallas(*x)


#: chunks of 1 page, 2 pages, and more than max_pages (one chunk a sequence)
CHUNKS = [1, 2, 64]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("tails", [False, True], ids=["full", "tails"])
@pytest.mark.parametrize("shape", SWEEP, ids=str)
def test_split_matches_pallas_and_one_pass(shape, tails, chunk):
    x, want = _split_case(shape, tails)
    q, kp, vp, bt, sl = x
    got = tref.paged_decode_attention_split(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), bt,
        sl, chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _plain(*x), rtol=1e-4, atol=1e-5)


def test_combine_of_one_chunk_is_its_normalised_partial():
    """A sequence of one chunk: acc / max(l, 1e-30), what the split kernel
    writes itself."""
    q, kp, vp, bt, sl = _inputs(*SWEEP[4], tails=True, seed=11)
    m, l, acc, starts = tref.chunk_partials(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), bt,
        sl, 64)
    np.testing.assert_array_equal(starts, np.arange(len(sl) + 1))
    got = tref.combine_partials(m, l, acc, starts)
    torch.testing.assert_close(got, acc / l[..., None], rtol=0, atol=0)


def _chunks(tables):
    """(sequence, first token, end token, first page, end page) of every
    chunk of a plan, in item order."""
    out = []
    ps, cp = tables.page_size, tables.chunk_pages
    for b, n in enumerate(np.diff(tables.chunk_start)):
        sl = int(tables.seq_lens[b])
        for j in range(n):
            t0, t1 = j * cp * ps, min((j + 1) * cp * ps, sl)
            out.append((b, t0, t1, j * cp, -(-t1 // ps)))
    return out


@pytest.mark.parametrize("page_size", [8, 64])
@pytest.mark.parametrize("chunk", [1, 2, 3, 5, None])
@pytest.mark.parametrize("lens", [[1], [63, 64, 65], [128, 129, 7, 300],
                                  [511, 2, 256]], ids=str)
def test_split_plan_covers_every_page_once(lens, chunk, page_size):
    """Every page a sequence's length reaches lies in exactly one chunk of
    that sequence, and every chunk is non-empty and ends within the
    length."""
    mp = -(-max(lens) // page_size)
    bt = np.arange(len(lens) * mp, dtype=np.int32).reshape(len(lens), mp)
    t = tops.prepare_tables(bt, lens, page_size=page_size,
                            num_pages=bt.size, kv_heads=2, device="cpu",
                            chunk_pages=chunk)
    assert t.chunk_start[0] == 0 and t.n_items == t.chunk_start[-1]
    seen = {}
    for b, t0, t1, p0, p1 in _chunks(t):
        assert 0 <= t0 < t1 <= lens[b]
        assert p1 - p0 <= t.chunk_pages
        for page in range(p0, p1):
            seen[b, page] = seen.get((b, page), 0) + 1
    want = {(b, p): 1 for b, n in enumerate(lens)
            for p in range(-(-n // page_size))}
    assert seen == want
    assert t.combine == any(-(-n // page_size) > t.chunk_pages for n in lens)
    # the kernel's plan entries: sequence, first token, end token, and
    # whether the chunk is its sequence's only one
    items = tops._items(t.seq_lens, t.chunk_start, page_size * t.chunk_pages)
    assert items.dtype == np.int32 and items.shape == (t.n_items, 4)
    np.testing.assert_array_equal(items[:, :3], [c[:3] for c in _chunks(t)])
    np.testing.assert_array_equal(
        items[:, 3], np.diff(t.chunk_start)[items[:, 0]] == 1)


def test_plan_fills_the_card():
    """One page a chunk at the serve main path's lengths (qwen2-1.5b, two
    KV heads, 64-token pages); at batch 8 with lengths up to 32768 no more
    than CTAS_PER_SM CTAs an SM, and at least a full wave of one a SM."""
    assert tops.plan_chunk_pages([263], 64, 2) == 1
    assert tops.plan_chunk_pages([201], 64, 2) == 1
    lens = np.random.default_rng(32).integers(1, 32769, 8)
    lens[0] = 32768
    cp = tops.plan_chunk_pages(lens, 64, 2)
    ctas = 2 * int(tref.chunk_starts(lens, 64, cp)[-1])
    sms = tops.DEFAULT_SMS
    assert sms <= ctas <= tops.CTAS_PER_SM * sms + 2 * len(lens)


def test_prepared_tables_equal_host_tables():
    """On the CPU the wrapper over prepared tables runs the same plain
    version as over host tables, and counts the same."""
    x = _inputs(*SWEEP[4], tails=True, seed=12)
    q, kp, vp, bt, sl = x
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    tops.reset_counts()
    host = tops.paged_decode_attention(*args, bt, sl)
    c_host = tops.counts()
    tops.reset_counts()
    t = tops.prepare_tables(bt, sl, page_size=kp.shape[1],
                            num_pages=kp.shape[0], kv_heads=kp.shape[2],
                            device="cpu")
    prep = tops.paged_decode_attention(*args, tables=t)
    torch.testing.assert_close(prep, host, rtol=0, atol=0)
    assert tops.counts() == c_host
    assert t.dev is None and t.key == tuple(sl.tolist())
    assert t.tokens == int(sl.sum())


#: bad tables: (what to change, the message both paths raise)
BAD_TABLES = {
    "length 0": ("sl0", "seq_lens must lie"),
    "length past the table": ("sl_big", "seq_lens must lie"),
    "-1 within the length": ("bt_neg", "outside"),
    "page past num_pages": ("bt_big", "outside"),
    "float table": ("bt_float", "integers"),
    "short table": ("bt_short", "do not fit"),
}


@pytest.mark.parametrize("case", list(BAD_TABLES))
def test_prepared_tables_raise_for_the_same_bad_tables(case):
    kind, msg = BAD_TABLES[case]
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=2)
    sl[:] = 17                        # both sequences use two pages
    bt = bt.copy()
    if kind == "sl0":
        sl[1] = 0
    elif kind == "sl_big":
        sl[1] = 33
    elif kind == "bt_neg":
        bt[0, 1] = -1
    elif kind == "bt_big":
        bt[0, 1] = kp.shape[0]
    elif kind == "bt_float":
        bt = bt.astype(np.float32)
    else:
        bt = bt[:1]
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    with pytest.raises(ValueError, match=msg):
        tops.paged_decode_attention(*args, bt, sl)
    with pytest.raises(ValueError, match=msg):
        tops.prepare_tables(bt, sl, page_size=16, num_pages=kp.shape[0],
                            kv_heads=2, device="cpu")


def test_wrapper_refuses_tables_of_other_pages():
    """Prepared tables are checked against the pages and q they meet: their
    shape, their device and the batch; host and prepared tables are not
    both given."""
    q, kp, vp, bt, sl = _inputs(2, 4, 2, 32, 16, 2, tails=False, seed=5)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    t = tops.prepare_tables(bt, sl, page_size=16, num_pages=kp.shape[0],
                            kv_heads=2, device="cpu")
    tops.paged_decode_attention(*args, tables=t)
    with pytest.raises(ValueError, match="tables prepared for"):
        tops.paged_decode_attention(args[0], args[1][1:], args[2][1:],
                                    tables=t)
    with pytest.raises(ValueError, match="do not fit batch"):
        tops.paged_decode_attention(args[0][:1], *args[1:], tables=t)
    with pytest.raises(TypeError, match="not both"):
        tops.paged_decode_attention(*args, bt, sl, tables=t)
    with pytest.raises(TypeError, match="DecodeTables"):
        tops.paged_decode_attention(*args, tables=(bt, sl))
    with pytest.raises(TypeError, match="or tables"):
        tops.paged_decode_attention(*args, bt)
    with pytest.raises(ValueError, match="chunk_pages"):
        tops.prepare_tables(bt, sl, page_size=16, num_pages=kp.shape[0],
                            kv_heads=2, device="cpu", chunk_pages=0)
