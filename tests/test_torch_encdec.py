"""The port's encoder-decoder serving half (``repro_torch.models.encdec``,
``serve.serve_step.serve_step_encdec``) against the JAX package's on the
CPU: the reference's ``init_encdec`` weights carried across bit for bit
(``interop.encdec_params_from_jax``), seeded NumPy frames and tokens;
``attention_cross``, ``encode``, ``encdec_prefill``, and the prompt fed a
token at a time through ``serve_step_encdec`` from
``encdec_init_caches`` and then greedy steps (logits, caches and tokens);
float32 within relative 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, bits, cpu_gen, load, np_tree, perturb, rel
from repro import configs as jconfigs
from repro.models import encdec as je, layers as jl
from repro.serve.serve_step import serve_step_encdec as jstep
from repro_torch.interop import encdec_params_from_jax
from repro_torch.models import encdec as te, layers as tl
from repro_torch.serve.serve_step import serve_step_encdec as tstep

ARCH = "seamless-m4t-medium"
JCFG = dataclasses.replace(jconfigs.reduced_config(ARCH), dtype="float32")
B, FRAMES, PROMPT, NEW = 2, 24, 9, 4


@pytest.fixture(scope="module")
def models():
    params = perturb(je.init_encdec(jax.random.PRNGKey(3), JCFG), 3)
    model = te.EncDec(JCFG, device="cpu")
    model.load_state_dict(encdec_params_from_jax(np_tree(params), JCFG))
    rng = np.random.default_rng(0)
    frames = rng.normal(0, 1, (B, FRAMES, JCFG.d_model)).astype(np.float32)
    toks = rng.integers(0, JCFG.vocab_size, (B, PROMPT))
    return params, model, frames, toks


@pytest.fixture(scope="module")
def reference_steps(models):
    """The reference: prefill logits, the memory, and the prompt fed a
    token at a time through serve_step_encdec, then NEW greedy steps (each
    step's logits and next tokens, and the final caches)."""
    params, _, frames, toks = models
    pre = je.encdec_prefill(params, jnp.asarray(frames), jnp.asarray(toks),
                            JCFG)
    memory = je.encode(params, jnp.asarray(frames), JCFG, remat=False)
    caches = je.encdec_init_caches(JCFG, B, PROMPT + NEW)
    logits, nxt = [], []
    tok = jnp.asarray(toks[:, :1])
    for t in range(PROMPT + NEW - 1):
        n, caches, lg = jstep(params, tok, memory, caches,
                              jnp.full((B,), t, jnp.int32), JCFG)
        logits.append(np.asarray(lg))
        nxt.append(np.asarray(n))
        tok = jnp.asarray(toks[:, t + 1:t + 2]) if t + 1 < PROMPT else n
    return pre, memory, logits, nxt, caches


def test_encdec_params_from_jax_bit_for_bit():
    params = je.init_encdec(jax.random.PRNGKey(5),
                            jconfigs.reduced_config(ARCH))
    cfg = jconfigs.reduced_config(ARCH)
    sd = encdec_params_from_jax(np_tree(params), cfg)
    te.EncDec(cfg, device="cpu").load_state_dict(sd, strict=True)
    n = 0
    for part, layers in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(params[part]):
            name = ".".join(k.key for k in path)
            for i in range(layers):
                np.testing.assert_array_equal(bits(sd[f"{part}.{i}.{name}"]),
                                              bits(np.asarray(leaf)[i]))
                n += 1
    assert len(sd) == n + 2 + len(params["embed"])
    assert sd["dec.0.xattn.wq"].dtype == torch.bfloat16


def test_attention_cross_matches_reference():
    p = perturb(jl.init_attention(jax.random.PRNGKey(6), JCFG), 6)
    mod = load(tl.Attention(JCFG, cpu_gen()), p)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (B, 5, JCFG.d_model)).astype(np.float32)
    mem = rng.normal(0, 1, (B, 13, JCFG.d_model)).astype(np.float32)
    want = jl.attention_cross(p, jnp.asarray(x), jnp.asarray(mem), JCFG)
    got = tl.attention_cross(mod, torch.from_numpy(x), torch.from_numpy(mem),
                             JCFG)
    assert got.shape == (B, 5, JCFG.d_model) and rel(want, got) < TOL
    # full (non-causal) self-attention, the encoder's
    want = jl.attention(p, jnp.asarray(mem), JCFG, causal=False)
    got = tl.attention(mod, torch.from_numpy(mem), JCFG, causal=False)
    assert rel(want, got) < TOL


def test_encode_and_prefill_match_reference(models, reference_steps):
    params, model, frames, toks = models
    pre, memory = reference_steps[:2]
    with torch.inference_mode():
        mem = te.encode(model, torch.from_numpy(frames), JCFG)
        got = te.encdec_prefill(model, torch.from_numpy(frames),
                                torch.from_numpy(toks), JCFG)
    assert rel(memory, mem) < TOL
    assert got.shape == (B, 1, JCFG.vocab_size) and got.dtype == torch.float32
    assert rel(pre, got) < TOL


def test_serve_step_encdec_matches_reference(models, reference_steps):
    """The prompt a token at a time, then greedy steps: every step's logits,
    the greedy tokens and the final self-attention caches; the last prompt
    step's logits equal the prefill's."""
    params, model, frames, toks = models
    pre, _, want_logits, want_next, want_caches = reference_steps
    with torch.inference_mode():
        memory = te.encode(model, torch.from_numpy(frames), JCFG)
        caches = te.encdec_init_caches(JCFG, B, PROMPT + NEW, "cpu")
        tok = torch.from_numpy(toks[:, :1])
        for t, (wl, wn) in enumerate(zip(want_logits, want_next)):
            n, caches, lg = tstep(model, tok, memory, caches,
                                  torch.full((B,), t), JCFG)
            assert rel(wl, lg) < TOL
            if t >= PROMPT - 1:
                np.testing.assert_array_equal(n.numpy(), wn)
            tok = torch.from_numpy(toks[:, t + 1:t + 2]) if t + 1 < PROMPT \
                else n
    assert rel(pre, want_logits[PROMPT - 1]) < TOL
    for j, t in zip(want_caches, caches):
        assert t.shape == j.shape and rel(j, t) < TOL
