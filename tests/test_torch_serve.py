"""The port's serving path against the JAX package's, on the CPU: configs,
the paged KV cache and its page plan, the weight converter, prefill and
decode (contiguous and paged) of reduced qwen2-1.5b, ``run_server``'s greedy
tokens and the batcher.  Inputs and weights are made from seeds (NumPy, or
the reference's ``init_lm`` carried across by ``interop.lm_params_from_jax``).

Tolerances: float32 models are held to relative 1e-4 (the two frameworks
sum in other orders); bfloat16 models to the reference's own prefill bound,
relative 3e-2 (``tests/test_models.py``), since bf16 rounds at other places
in the two frameworks.  The paged decode on the CPU runs the kernel's plain
version; the card's kernel is held against it in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.bytecode import encode_chunk as jencode
from repro.launch.serve import run_server as jrun_server
from repro.models import init_lm as jinit_lm, lm_decode as jlm_decode, \
    lm_prefill as jlm_prefill
from repro.serve import paged_kv as jpkv
from repro.serve.serve_step import Batcher as JBatcher, Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.bytecode import encode_chunk as tencode
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.paged_attn import ops as pops
from repro_torch.launch import serve as tserve
from repro_torch.models import LM, init_caches, init_lm, lm_decode, \
    lm_prefill
from repro_torch.serve import paged_kv as tpkv
from repro_torch.serve.serve_step import Batcher, Request, serve_step

ARCH = "qwen2-1.5b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    """bf16 -> its uint16 bits, from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for fn in ("get_config", "reduced_config"):
        assert dataclasses.asdict(getattr(tconfigs, fn)(arch)) == \
            dataclasses.asdict(getattr(jconfigs, fn)(arch))
    cfg = tconfigs.get_config(arch)
    assert tconfigs.applicable_shapes(cfg) == \
        jconfigs.applicable_shapes(jconfigs.get_config(arch))
    assert cfg.param_count_estimate() == \
        jconfigs.get_config(arch).param_count_estimate()
    # LM builds for every arch: vlm and audio as ATTN stacks, like the
    # reference's init_lm
    small = tconfigs.reduced_config(arch)
    model = LM(small, device="cpu")
    assert len(model.blocks) == small.n_layers and \
        hasattr(model, "shared_attn") == bool(small.shared_attn_every)


def test_seeded_init_is_deterministic():
    cfg = tconfigs.reduced_config(ARCH)
    a, b = init_lm(cfg, 0, "cpu"), init_lm(cfg, 0, "cpu")
    c = init_lm(cfg, 1, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.1.attn.wq"], sc["blocks.1.attn.wq"])
    assert sa["blocks.0.attn.wq"].dtype == torch.bfloat16
    assert not sa["blocks.0.attn.q_bias"].any()      # biases start at 0
    w = sa["blocks.0.mlp.w_down"].float()             # scale d_ff ** -0.5
    assert abs(float(w.std()) * cfg.d_ff ** 0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# the paged KV cache and its page plan
# ---------------------------------------------------------------------------

#: (sequence, tokens) appends, interleaved across three sequences
APPENDS = [(0, 3), (2, 5), (1, 4), (0, 6), (2, 1), (1, 1), (0, 2), (2, 7)]


def _token_stream(rng, n, kvh=2, hd=8):
    return (rng.normal(0, 1, (n, kvh, hd)).astype(np.float32),
            rng.normal(0, 1, (n, kvh, hd)).astype(np.float32))


def test_paged_cache_matches_reference_appends():
    rng = np.random.default_rng(0)
    cfg = tpkv.PagedKVConfig(page_size=4, max_pages_per_seq=6)
    jc = jpkv.PagedKVCache(jpkv.PagedKVConfig(page_size=4,
                                              max_pages_per_seq=6),
                           14, 3, 2, 8)
    tc = tpkv.PagedKVCache(cfg, 14, 3, 2, 8, device="cpu")
    for seq, n in APPENDS:
        k, v = _token_stream(rng, n)
        for t in range(n):
            jc.append(seq, jnp.asarray(k[t], jnp.bfloat16),
                      jnp.asarray(v[t], jnp.bfloat16))
            tc.append(seq, torch.from_numpy(k[t])[None],
                      torch.from_numpy(v[t])[None])
    np.testing.assert_array_equal(tc.block_table, jc.block_table)
    np.testing.assert_array_equal(tc.seq_lens, jc.seq_lens)
    assert tc.block_table[0, 0] == 0                # page 0 goes first
    np.testing.assert_array_equal(_bits(tc.k_pages[0]), _bits(jc.k_pages))
    np.testing.assert_array_equal(_bits(tc.v_pages[0]), _bits(jc.v_pages))


def test_write_prefill_and_append_step_equal_token_appends():
    """A run of tokens written at once, and a decode step's slots written
    layer by layer, store what one-at-a-time appends store."""
    rng = np.random.default_rng(1)
    cfg = tpkv.PagedKVConfig(page_size=4, max_pages_per_seq=5)
    one = tpkv.PagedKVCache(cfg, 12, 2, 2, 8, torch.float32, n_layers=3,
                            device="cpu")
    bulk = tpkv.PagedKVCache(cfg, 12, 2, 2, 8, torch.float32, n_layers=3,
                             device="cpu")
    k = torch.from_numpy(rng.normal(0, 1, (2, 3, 11, 2, 8)))
    v = torch.from_numpy(rng.normal(0, 1, (2, 3, 11, 2, 8)))
    for seq, n in ((0, 9), (1, 6)):
        bulk.write_prefill(seq, k[seq, :, :n], v[seq, :, :n])
        for t in range(n):
            one.append(seq, k[seq, :, t], v[seq, :, t])
    for t in (9, 10):     # decode steps: both sequences grow by one
        step = bulk.append_step()
        pos = [t, t - 3]
        assert step.positions.tolist() == pos
        np.testing.assert_array_equal(step.tables.seq_lens, [t + 1, t - 2])
        for layer in range(3):
            bulk.write(layer, step, torch.stack([k[0, layer, t],
                                                 k[1, layer, t - 3]]),
                       torch.stack([v[0, layer, t], v[1, layer, t - 3]]))
        for seq in (0, 1):
            one.append(seq, k[seq, :, pos[seq]], v[seq, :, pos[seq]])
    np.testing.assert_array_equal(bulk.block_table, one.block_table)
    np.testing.assert_array_equal(bulk.seq_lens, one.seq_lens)
    assert torch.equal(bulk.k_pages, one.k_pages)
    assert torch.equal(bulk.v_pages, one.v_pages)


def test_paged_cache_refuses_overflow():
    cfg = tpkv.PagedKVConfig(page_size=2, max_pages_per_seq=2)
    c = tpkv.PagedKVCache(cfg, 3, 2, 1, 4, device="cpu")
    with pytest.raises(RuntimeError, match="max_pages_per_seq"):
        c.write_prefill(0, torch.zeros(1, 5, 1, 4), torch.zeros(1, 5, 1, 4))
    c = tpkv.PagedKVCache(cfg, 3, 2, 1, 4, device="cpu")
    c.write_prefill(0, torch.zeros(1, 4, 1, 4), torch.zeros(1, 4, 1, 4))
    with pytest.raises(RuntimeError, match="out of pages"):
        c.write_prefill(1, torch.zeros(1, 3, 1, 4), torch.zeros(1, 3, 1, 4))


@pytest.mark.parametrize("tokens,page", [(64, 16), (512, 16), (265, 33)])
def test_kv_trace_matches_reference(tokens, page):
    t, j = tpkv.decode_kv_trace(tokens, page), jpkv.decode_kv_trace(tokens,
                                                                    page)
    np.testing.assert_array_equal(tencode(t.instrs), jencode(j.instrs))
    assert (t.page_shift, t.protocol, t.vspace_slots, t.meta) == \
        (j.page_shift, j.protocol, j.vspace_slots, j.meta)


@pytest.mark.parametrize("args", [(512, 16, 12, 8, 3), (265, 33, 4, 4, 2),
                                  (4096, 64, 20, 16, 4)])
def test_kv_plan_matches_reference(args):
    tm, tr = tpkv.plan_kv_schedule(*args)
    jm, jr = jpkv.plan_kv_schedule(*args)
    for name in ("swap_ins", "swap_outs", "dropped_dirty", "num_frames"):
        assert getattr(tr.replacement, name) == getattr(jr.replacement, name)
    for name in ("prefetched", "sync_fallbacks", "canceled_prefetches"):
        assert getattr(tr.schedule, name) == getattr(jr.schedule, name)
    assert tr.replacement.swap_ins > 0
    np.testing.assert_array_equal(tencode(tm.instrs), jencode(jm.instrs))


# ---------------------------------------------------------------------------
# weights and the model
# ---------------------------------------------------------------------------


def _models(dtype: str, seed: int = 1, biases: bool = True):
    """The reference's seeded reduced qwen2 (nonzero q/k/v biases drawn
    with NumPy) and the port's LM holding the same weights."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced_config(ARCH), dtype=dtype)
    params = jinit_lm(jax.random.PRNGKey(seed), jcfg)
    if biases:
        rng = np.random.default_rng(seed)
        attn = params["groups"][0]["attn"]
        for name in ("q_bias", "k_bias", "v_bias"):
            attn[name] = jnp.asarray(rng.normal(0, 0.5, attn[name].shape),
                                     dtype=attn[name].dtype)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(params), tcfg))
    return params, jcfg, model, tcfg


def test_lm_params_from_jax_bit_for_bit():
    params, _, model, tcfg = _models("bfloat16")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(sd) == sum(tcfg.n_layers if "groups" in jax.tree_util.keystr(
        p) else 1 for p, _ in leaves)
    g = params["groups"][0]
    for i in range(tcfg.n_layers):
        for mod, names in (("attn", ("wq", "wk", "wv", "wo", "q_bias",
                                     "k_bias", "v_bias")),
                           ("mlp", ("w_gate", "w_up", "w_down"))):
            for n in names:
                t = sd[f"blocks.{i}.{mod}.{n}"]
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(t), _bits(g[mod][n][i]))
        np.testing.assert_array_equal(sd[f"blocks.{i}.ln1.scale"].numpy(),
                                      np.asarray(g["ln1"]["scale"][i]))
    for n in ("embed", "lm_head"):
        np.testing.assert_array_equal(_bits(sd[f"embed.{n}"]),
                                      _bits(params["embed"][n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and caches, then one decode step through the
    contiguous cache and through a paged cache, against the reference's
    prefill and contiguous decode."""
    params, jcfg, model, tcfg = _models(dtype)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 21))
    plen, max_seq = 20, 32
    jl, jc = jlm_prefill(params, jnp.asarray(toks[:, :plen]), jcfg, max_seq)
    with torch.inference_mode():
        tl, tc = lm_prefill(model, torch.from_numpy(toks[:, :plen]), tcfg,
                            max_seq)
    assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    assert _rel(jl, tl) < TOL[dtype]
    for jt, tt in zip(jc[0], tc[0]):
        assert tt.shape == jt.shape and tt.dtype == getattr(torch, dtype)
        assert _rel(jt, tt.float()) < TOL[dtype]
    clen = np.full(2, plen, dtype=np.int32)
    jd, _ = jlm_decode(params, jnp.asarray(toks[:, plen:]), jc,
                       jnp.asarray(clen), jcfg)
    with torch.inference_mode():
        td, _ = lm_decode(model, torch.from_numpy(toks[:, plen:]), tc,
                          torch.from_numpy(clen).long(), tcfg)
        assert _rel(jd, td) < TOL[dtype]
        # the paged decode over the prompt's K/V (without padding)
        _, pc = lm_prefill(model, torch.from_numpy(toks[:, :plen]), tcfg,
                           plen)
        cache = tpkv.PagedKVCache(
            tpkv.PagedKVConfig(page_size=8, max_pages_per_seq=4), 8, 2,
            tcfg.n_kv_heads, tcfg.head_dim, getattr(torch, dtype),
            n_layers=tcfg.n_layers, device="cpu")
        for seq in (0, 1):
            cache.write_prefill(seq, pc[0][0][:, seq], pc[0][1][:, seq])
        pops.reset_counts()
        pd, _ = lm_decode(model, torch.from_numpy(toks[:, plen:]), cache,
                          None, tcfg)
    assert _rel(jd, pd) < TOL[dtype]
    assert pops.counts()["plain_calls"] == tcfg.n_layers
    np.testing.assert_array_equal(cache.seq_lens, [plen + 1, plen + 1])
    with pytest.raises(ValueError, match="own lengths"):
        lm_decode(model, torch.from_numpy(toks[:, plen:]), cache,
                  torch.from_numpy(clen), tcfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVE = dict(n_req=3, prompt=40, max_new=8)


@pytest.fixture(scope="module")
def reference_serve():
    """The reference's run_server at f32 (its weights: init_lm(PRNGKey(0)),
    zero biases) on seeded prompts; returns the prompts, the tokens and
    the printed page-plan line."""
    import contextlib
    import io
    cfg = dataclasses.replace(jconfigs.reduced_config(ARCH),
                              dtype="float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE["prompt"])
               for _ in range(SERVE["n_req"])]
    reqs = [JRequest(i, p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jrun_server(cfg, reqs, 2, SERVE["prompt"] + SERVE["max_new"] + 1,
                    paged_report=True)
    return prompts, [r.output for r in reqs], out.getvalue().strip()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_run_server_tokens_match_reference(reference_serve, paged, capsys):
    prompts, want, plan_line = reference_serve
    params, _, model, tcfg = _models("float32", seed=0, biases=False)
    reqs = [Request(i, p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    pops.reset_counts()
    st = tserve.run_server(tcfg, reqs, 2,
                           SERVE["prompt"] + SERVE["max_new"] + 1,
                           paged=paged, params=model)
    assert [r.output for r in reqs] == want
    assert all(r.done for r in reqs)
    steps = SERVE["n_req"] * (SERVE["max_new"] - 1)
    assert st.decode_tokens == steps
    assert st.prefill_tokens == SERVE["n_req"] * SERVE["prompt"]
    assert pops.counts()["plain_calls"] == (steps * tcfg.n_layers if paged
                                            else 0)
    printed = capsys.readouterr().out.strip()
    assert printed == (plan_line if paged else "")


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--paged", "--requests",
                 "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "paged-KV plan" in out and "served 2 requests, 4 decode" in out


def test_serve_step_samples_with_a_generator():
    cfg = tconfigs.reduced_config(ARCH)
    model = init_lm(cfg, 0, "cpu")
    caches = init_caches(cfg, 2, 8, "cpu")
    tok = torch.tensor([[3], [5]])
    draws = []
    with torch.inference_mode():
        for _ in range(2):
            g = torch.Generator().manual_seed(11)
            nxt, _, logits = serve_step(model, tok, caches,
                                        torch.zeros(2, dtype=torch.long),
                                        cfg, temperature=0.8, generator=g)
            draws.append(nxt)
    assert draws[0].shape == (2, 1) and torch.equal(draws[0], draws[1])
    greedy, _, _ = serve_step(model, tok, caches,
                              torch.zeros(2, dtype=torch.long), cfg)
    assert torch.equal(greedy, logits[:, -1].argmax(-1, keepdim=True))


def test_batcher_matches_reference():
    jb, tb = JBatcher(2), Batcher(2)
    for i in range(5):
        jb.submit(JRequest(rid=i, prompt=np.arange(4), max_new=2))
        tb.submit(Request(rid=i, prompt=np.arange(4), max_new=2))

    def rids(placed):
        return [(i, r.rid) for i, r in placed]
    for retire in ([], [0], [1, 0], [0], [1], [0]):
        for i in retire:
            jb.retire(i)
            tb.retire(i)
        assert rids(tb.fill()) == rids(jb.fill())
        assert [r and r.rid for r in tb.active] == \
            [r and r.rid for r in jb.active]
        assert tb.busy() == jb.busy()


def test_append_step_prepares_the_tables_once():
    """A decode step's tables are checked and split once, for the cache's
    pages, and every layer's attention reads that one object."""
    cfg = tpkv.PagedKVConfig(page_size=4, max_pages_per_seq=5)
    cache = tpkv.PagedKVCache(cfg, 12, 2, 2, 8, torch.float32, n_layers=3,
                              device="cpu")
    z = torch.zeros(3, 7, 2, 8)
    cache.write_prefill(0, z, z)
    cache.write_prefill(1, z[:, :4], z[:, :4])
    step = cache.append_step()
    t = step.tables
    assert isinstance(t, pops.DecodeTables)
    assert (t.num_pages, t.page_size, t.kv_heads) == (12, 4, 2)
    np.testing.assert_array_equal(t.seq_lens, [8, 5])
    np.testing.assert_array_equal(t.block_table, cache.block_table)
    assert t.chunk_pages == 1 and t.n_items == 4 and t.dev is None
    cache.append_step()       # the next step's tables are new; these stay
    np.testing.assert_array_equal(t.seq_lens, [8, 5])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_head_dim_80_serves(paged):
    """stablelm-3b's head_dim of 80 (32 query heads over 32 KV heads at
    full width), here on the reduced model: the paged decode's greedy
    tokens equal the contiguous decode's, one plain paged call per layer
    and step."""
    cfg = dataclasses.replace(tconfigs.reduced_config("stablelm-3b"),
                              head_dim=80,
                              dtype="float32")
    assert cfg.n_heads == cfg.n_kv_heads
    model = init_lm(cfg, 0, "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 20) for _ in range(2)]
    outs = {}
    for p in (True, False):
        reqs = [Request(i, x, max_new=5) for i, x in enumerate(prompts)]
        pops.reset_counts()
        tserve.run_server(cfg, reqs, 2, 26, paged=p, params=model)
        outs[p] = [r.output for r in reqs]
        assert pops.counts()["plain_calls"] == (2 * 4 * cfg.n_layers
                                                if p else 0)
    assert outs[paged] == outs[not paged]
