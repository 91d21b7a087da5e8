"""Every model family of the port's serving path against the JAX package's,
on the CPU at the reduced configs: the weight carrier for every layout
(scan groups, xLSTM's and the hybrid's rep groups, zamba2's one shared
block, MoE, Mamba2, mLSTM and sLSTM leaves) bit for bit; prefill logits
and every cache leaf, then a decode step's logits and caches, of
deepseek-moe-16b, phi3.5-moe, zamba2-7b, xlstm-1.3b, chameleon-34b,
seamless-m4t-medium (an ATTN stack, as the reference's CLI serves it) and
qwen2-1.5b with the int8 KV cache, at float32 within relative 1e-4; the
paged decode of each (one plain paged call an attention application; none
for xLSTM; int8 refused); ``_quantize_kv`` bit for bit; ``_sdpa_chunked``
against the reference's and the dense form, called directly and through
``_sdpa`` with the threshold lowered in both packages; ``run_server``'s
greedy tokens against the reference's; and the CLI for every arch."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, bits, np_tree, rel, tree_rel
from repro import configs as jconfigs
from repro.launch.serve import run_server as jrun_server
from repro.models import init_lm as jinit_lm, layers as jl, \
    lm_decode as jlm_decode, lm_prefill as jlm_prefill
from repro.models.lm import grouped_layout as jgrouped_layout
from repro.serve.serve_step import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.paged_attn import ops as pops
from repro_torch.launch import serve as tserve
from repro_torch.models import LM, PagedCaches, layers as tl, lm as tlm, \
    lm_decode, lm_prefill
from repro_torch.serve.serve_step import Request

#: (arch, kv_cache_dtype) of the families this slice serves
FAMILIES = [("deepseek-moe-16b", "bfloat16"),
            ("phi3.5-moe-42b-a6.6b", "bfloat16"), ("zamba2-7b", "bfloat16"),
            ("xlstm-1.3b", "bfloat16"), ("chameleon-34b", "bfloat16"),
            ("seamless-m4t-medium", "bfloat16"), ("qwen2-1.5b", "int8")]
PLEN, MAX_SEQ = 20, 32


def _cfgs(arch: str, dtype: str = "float32", kv: str = "bfloat16"):
    return tuple(dataclasses.replace(c.reduced_config(arch), dtype=dtype,
                                     kv_cache_dtype=kv)
                 for c in (jconfigs, tconfigs))


def _model(params, tcfg) -> LM:
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(np_tree(params), tcfg),
                          strict=True)
    return model


def _n_attn(cfg) -> int:
    return sum(a.attn is not None for a in tlm.applications(cfg))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_lm_params_from_jax_bit_for_bit(arch):
    """Every reference leaf of every layer lands in its block bit for bit,
    and the state dict has nothing else."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    sd = lm_params_from_jax(np_tree(params), tcfg)
    LM(tcfg, device="cpu").load_state_dict(sd, strict=True)
    n = 0
    for app in tlm.applications(tcfg):
        if app.block is None:
            continue
        tree = params["groups"][app.group]
        tree = tree if app.seg is None else tree[app.seg]
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            name = ".".join(k.key for k in path)
            got = sd[f"blocks.{app.block}.{name}"]
            np.testing.assert_array_equal(bits(got),
                                          bits(np.asarray(leaf)[app.index]))
            n += 1
    shared = jax.tree_util.tree_leaves_with_path(params.get("shared_attn",
                                                            {}))
    for path, leaf in shared:
        name = ".".join(k.key for k in path)
        np.testing.assert_array_equal(bits(sd[f"shared_attn.{name}"]),
                                      bits(leaf))
    assert len(sd) == n + len(shared) + 1 + len(params["embed"])


# ---------------------------------------------------------------------------
# prefill and decode, each family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES,
                ids=[f"{a}-{k}" for a, k in FAMILIES])
def family(request):
    """The reference's prefill and one decode step of a family at f32 on
    seeded prompts, and the port's LM holding the same weights."""
    arch, kv = request.param
    jcfg, tcfg = _cfgs(arch, kv=kv)
    params = jinit_lm(jax.random.PRNGKey(1), jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, PLEN + 1))
    jlog, jcache = jlm_prefill(params, jnp.asarray(toks[:, :PLEN]), jcfg,
                               MAX_SEQ)
    clen = jnp.full((2,), PLEN, jnp.int32)
    jdec, jcache2 = jlm_decode(params, jnp.asarray(toks[:, PLEN:]), jcache,
                               clen, jcfg)
    return dict(tcfg=tcfg, model=_model(params, tcfg), toks=toks,
                prefill=(np.asarray(jlog), np_tree(jcache)),
                decode=(np.asarray(jdec), np_tree(jcache2)))


def test_prefill_matches_reference(family):
    f = family
    with torch.inference_mode():
        logits, caches = lm_prefill(f["model"],
                                    torch.from_numpy(f["toks"][:, :PLEN]),
                                    f["tcfg"], MAX_SEQ)
    assert logits.shape == (2, 1, f["tcfg"].vocab_size)
    assert rel(f["prefill"][0], logits) < TOL
    assert tree_rel(f["prefill"][1], caches) < TOL


def test_decode_matches_reference(family):
    """One contiguous decode step after the port's prefill: logits and
    every cache leaf (attention caches written in place, states
    replaced)."""
    f = family
    tok = torch.from_numpy(f["toks"])
    with torch.inference_mode():
        _, caches = lm_prefill(f["model"], tok[:, :PLEN], f["tcfg"], MAX_SEQ)
        logits, caches2 = lm_decode(f["model"], tok[:, PLEN:], caches,
                                    torch.full((2,), PLEN), f["tcfg"])
    assert caches2 is caches
    assert rel(f["decode"][0], logits) < TOL
    assert tree_rel(f["decode"][1], caches2) < TOL


def test_paged_decode_matches_reference(family):
    """The paged decode after an unpadded prefill: each attention
    application (every ATTN layer, the hybrid's shared-block applications)
    through one plain paged call; the states beside it; the logits of the
    reference's contiguous decode.  int8 has no paged decode."""
    f = family
    cfg = f["tcfg"]
    tok = torch.from_numpy(f["toks"])
    with torch.inference_mode():
        _, caches = lm_prefill(f["model"], tok[:, :PLEN], cfg, PLEN)
        if cfg.kv_cache_dtype == "int8":
            with pytest.raises(ValueError, match="int8"):
                tserve.paged_cache(cfg, caches, MAX_SEQ)
            return
        paged = tserve.paged_cache(cfg, caches, MAX_SEQ)
        assert isinstance(paged, PagedCaches)
        pops.reset_counts()
        logits, _ = lm_decode(f["model"], tok[:, PLEN:], paged, None, cfg)
    n_attn = _n_attn(cfg)
    assert pops.counts()["plain_calls"] == n_attn
    if n_attn:
        assert paged.kv.k_pages.shape[0] == n_attn
        np.testing.assert_array_equal(paged.kv.seq_lens, [PLEN + 1] * 2)
    else:
        assert paged.kv is None
    assert rel(f["decode"][0], logits) < TOL
    with pytest.raises(ValueError, match="own lengths"):
        lm_decode(f["model"], tok[:, PLEN:], paged, torch.full((2,), PLEN),
                  cfg)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_bf16_follows_reference(arch):
    """In bfloat16 (the served dtype) prefill and a decode step stay
    within the reference's own bf16 bound, relative 3e-2
    (``tests/test_models.py``; ``test_torch_serve.py``'s TOL): the port
    rounds to bf16 where the reference does."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = jinit_lm(jax.random.PRNGKey(1), jcfg)
    model = _model(params, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, PLEN + 1))
    jlog, jcache = jlm_prefill(params, jnp.asarray(toks[:, :PLEN]), jcfg,
                               MAX_SEQ)
    jdec, _ = jlm_decode(params, jnp.asarray(toks[:, PLEN:]), jcache,
                         jnp.full((2,), PLEN, jnp.int32), jcfg)
    tok = torch.from_numpy(toks)
    with torch.inference_mode():
        logits, caches = lm_prefill(model, tok[:, :PLEN], tcfg, MAX_SEQ)
        assert rel(jlog, logits) < 3e-2
        logits, _ = lm_decode(model, tok[:, PLEN:], caches,
                              torch.full((2,), PLEN), tcfg)
    assert rel(jdec, logits) < 3e-2


def test_layouts_and_applications():
    """zamba2-7b at full size: 13 rep groups of (MAMBA2 x 6, SHARED_ATTN)
    and a tail of 3, 81 blocks and 13 attention applications of the one
    shared block; xlstm-1.3b: (MLSTM x 7, SLSTM) x 6."""
    z = tconfigs.get_config("zamba2-7b")
    assert tlm.grouped_layout(z) == [
        ("rep", ((tlm.BlockKind.MAMBA2, 6), (tlm.BlockKind.SHARED_ATTN, 1)),
         13), ("scan", tlm.BlockKind.MAMBA2, 3)]
    apps = tlm.applications(z)
    assert sum(a.block is not None for a in apps) == 81
    assert [a.attn for a in apps if a.block is None] == list(range(13))
    x = tconfigs.get_config("xlstm-1.3b")
    assert tlm.grouped_layout(x) == [
        ("rep", ((tlm.BlockKind.MLSTM, 7), (tlm.BlockKind.SLSTM, 1)), 6)]
    assert _n_attn(x) == 0
    for arch in jconfigs.ARCHS:
        cfg = jconfigs.get_config(arch)
        assert tlm.grouped_layout(cfg) == jgrouped_layout(cfg)


# ---------------------------------------------------------------------------
# int8 and long prompts: the layers
# ---------------------------------------------------------------------------


def test_quantize_kv_bit_for_bit():
    """Int8 payloads and f16 scales equal the reference's bit for bit, on
    seeded K/V, a zero row (the 1e-6 floor) and halves (round half to
    even)."""
    x = np.random.default_rng(3).normal(0, 2, (2, 33, 3, 16)) \
        .astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    for dt in (jnp.float32, jnp.bfloat16):
        jq, js = jl._quantize_kv(jnp.asarray(x, dt))
        tq, ts = tl._quantize_kv(torch.from_numpy(x).to(
            getattr(torch, jnp.dtype(dt).name)))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(bits(ts), bits(js))
    assert tq[1, 2, 1, :6].tolist() == [127, 0, 2, 2, 0, -4]


@pytest.mark.parametrize("sq,skv,causal", [
    (37, 37, True), (64, 64, True), (37, 37, False), (64, 64, False),
    (9, 30, False)])
def test_sdpa_chunked_matches_reference(sq, skv, causal):
    """Small q and kv blocks (8 and 16: padding on both sides, masked
    padded keys), against the reference's chunked form and against the
    dense form; the causal form as prefill calls it (sq == skv), the full
    form also as cross-attention does (other lengths)."""
    cfg = tconfigs.reduced_config("qwen2-1.5b")
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(0, 1, (2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    off = 0 if causal else None
    got = tl._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), cfg, off, 8,
                           16)
    want = jl._sdpa_chunked(*map(jnp.asarray, (q, k, v)), cfg, off, 8, 16)
    dense = tl._sdpa_dense(*map(torch.from_numpy, (q, k, v)), cfg, off)
    assert got.shape == (2, sq, 64)
    assert rel(want, got) < TOL and rel(dense, got) < TOL


def test_prefill_through_chunked_sdpa(monkeypatch):
    """With CHUNKED_SDPA_THRESHOLD lowered on both packages, a prompt
    prefills through _sdpa_chunked (the default blocks): logits and caches
    equal the reference's chunked prefill and the port's dense one."""
    jcfg, tcfg = _cfgs("qwen2-1.5b")
    params = jinit_lm(jax.random.PRNGKey(4), jcfg)
    model = _model(params, tcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 40))
    with torch.inference_mode():
        dense = lm_prefill(model, torch.from_numpy(toks), tcfg, 48)
    calls = []
    chunked = tl._sdpa_chunked
    monkeypatch.setattr(tl, "_sdpa_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    monkeypatch.setattr(tl, "CHUNKED_SDPA_THRESHOLD", 16)
    monkeypatch.setattr(jl, "CHUNKED_SDPA_THRESHOLD", 16)
    jlog, jcache = jlm_prefill(params, jnp.asarray(toks), jcfg, 48)
    with torch.inference_mode():
        logits, caches = lm_prefill(model, torch.from_numpy(toks), tcfg, 48)
    assert len(calls) == tcfg.n_layers
    assert rel(jlog, logits) < TOL and tree_rel(np_tree(jcache), caches) < TOL
    assert rel(dense[0], logits) < TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVE = dict(n_req=2, prompt=10, max_new=4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_run_server_tokens_match_reference(arch, capsys):
    """The reference's run_server at f32 (its weights, init_lm(PRNGKey(0)))
    and the port's, paged and contiguous: the same greedy tokens and the
    same printed page-plan line."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, SERVE["prompt"])
               for _ in range(SERVE["n_req"])]
    max_seq = SERVE["prompt"] + SERVE["max_new"] + 1
    reqs = [JRequest(i, p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jrun_server(jcfg, reqs, 2, max_seq, paged_report=True)
    want = [r.output for r in reqs]
    model = _model(jinit_lm(jax.random.PRNGKey(0), jcfg), tcfg)
    capsys.readouterr()
    steps = SERVE["n_req"] * (SERVE["max_new"] - 1)
    for paged in (True, False):
        treqs = [Request(i, p, max_new=SERVE["max_new"])
                 for i, p in enumerate(prompts)]
        pops.reset_counts()
        tserve.run_server(tcfg, treqs, 2, max_seq, paged=paged, params=model)
        assert [r.output for r in treqs] == want
        assert pops.counts()["plain_calls"] == \
            (steps * _n_attn(tcfg) if paged else 0)
        assert capsys.readouterr().out.strip() == \
            (out.getvalue().strip() if paged else "")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_serve_cli_every_arch(arch, paged, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu [--paged]`` serves every arch of the reference's CLI."""
    pops.reset_counts()
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "6", "--max-new", "3"]
                + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 2 requests, 4 decode tokens" in out
    assert ("paged-KV plan" in out) == paged
    n_attn = _n_attn(tconfigs.reduced_config(arch))
    assert pops.counts()["plain_calls"] == (4 * n_attn if paged else 0)


def test_int8_serves_contiguous_and_refuses_paged(monkeypatch, capsys):
    """int8 is chosen through cfg.kv_cache_dtype, as in the reference: it
    serves contiguously; under --paged (run_server or the CLI) it raises
    ValueError before any work."""
    cfg = dataclasses.replace(tconfigs.reduced_config("qwen2-1.5b"),
                              kv_cache_dtype="int8")
    reqs = [Request(0, np.arange(6), max_new=3)]
    st = tserve.run_server(cfg, reqs, 2, 10, device="cpu")
    assert st.decode_tokens == 2 and len(reqs[0].output) == 3
    with pytest.raises(ValueError, match="int8"):
        tserve.run_server(cfg, [Request(0, np.arange(6), max_new=3)], 2, 10,
                          paged=True, device="cpu")
    monkeypatch.setattr(tserve, "reduced_config", lambda arch: cfg)
    with pytest.raises(ValueError, match="int8"):
        tserve.main(["--reduced", "--device", "cpu", "--paged"])
    tserve.main(["--reduced", "--device", "cpu", "--requests", "1",
                 "--prompt-len", "5", "--max-new", "2"])
    assert "served 1 requests" in capsys.readouterr().out
