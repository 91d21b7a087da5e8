"""The port's training forward and losses against the JAX package's on the
CPU: the reference's weights carried across (``interop.lm_params_from_jax``,
``encdec_params_from_jax``), seeded NumPy batches;
``lm_loss`` and every gradient of qwen2-1.5b, deepseek-moe-16b (the MoE
aux loss included), zamba2-7b (one shared block at several applications)
and xlstm-1.3b, ``encdec_loss`` and its gradients for seamless-m4t-medium,
at the reduced configs in float32 within relative 1e-4; remat against no
remat; ``lm_forward``'s last position against ``lm_prefill``; and serving
models without ``requires_grad``.  The optimizer and the train step against the
reference are in ``test_torch_train_fault.py`` (this file's time
budget)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, np_tree, perturb, rel
from repro import configs as jconfigs
from repro.models import encdec_loss as jencdec_loss, init_encdec as \
    jinit_encdec, init_lm as jinit_lm, lm_loss as jlm_loss
from repro_torch import configs as tconfigs
from repro_torch.interop import encdec_params_from_jax, lm_params_from_jax
from repro_torch.models import (EncDec, LM, encdec_loss, init_encdec,
                                init_lm, lm_forward, lm_loss, lm_prefill)
from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                          pipeline_train_step)

LM_FAMILIES = ["qwen2-1.5b", "deepseek-moe-16b", "zamba2-7b", "xlstm-1.3b"]
ENCDEC = "seamless-m4t-medium"
B, S = 2, 17


@pytest.fixture(scope="module")
def jinit():
    """The reference's ``init_lm`` / ``init_encdec`` at PRNGKey(0), once an
    arch (each takes seconds to compile)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = _cfgs(arch)[0]
            init = jinit_encdec if jcfg.is_encdec else jinit_lm
            cache[arch] = init(jax.random.PRNGKey(0), jcfg)
        return cache[arch]
    return get


def _cfgs(arch: str, dtype: str = "float32"):
    return tuple(dataclasses.replace(c.reduced_config(arch), dtype=dtype)
                 for c in (jconfigs, tconfigs))


def _port(params, tcfg):
    """The port's model holding the reference's weights, training."""
    model = (EncDec if tcfg.is_encdec else LM)(tcfg, device="cpu")
    conv = encdec_params_from_jax if tcfg.is_encdec else lm_params_from_jax
    model.load_state_dict(conv(np_tree(params), tcfg), strict=True)
    return model.requires_grad_(True)


def _grads(total, model) -> dict:
    names, ps = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(total, ps)))


def _grads_rel(jgrads, tgrads: dict, tcfg) -> float:
    conv = encdec_params_from_jax if tcfg.is_encdec else lm_params_from_jax
    want = conv(np_tree(jgrads), tcfg)
    assert want.keys() == tgrads.keys()
    return max(rel(want[k], tgrads[k]) for k in want)


def _tokens(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# losses and gradients against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_loss_and_grads_match_reference(arch, jinit):
    jcfg, tcfg = _cfgs(arch)
    params = perturb(jinit(arch), 5)
    toks = _tokens(jcfg, 6)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jnp.asarray(toks), jcfg), has_aux=True))(params)
    model = _port(params, tcfg)
    ttot, tm = lm_loss(model, torch.from_numpy(toks), tcfg)
    for key in ("loss", "aux", "ppl_proxy"):
        assert rel(jm[key], tm[key]) < TOL, key
    assert rel(jtot, ttot) < TOL
    if tcfg.moe:
        assert float(tm["aux"]) > 0
    assert _grads_rel(jg, _grads(ttot, model), tcfg) < TOL


def test_encdec_loss_and_grads_match_reference(jinit):
    jcfg, tcfg = _cfgs(ENCDEC)
    params = perturb(jinit(ENCDEC), 7)
    toks = _tokens(jcfg, 8)
    frames = np.random.default_rng(9).normal(
        0, 1, (B, 12, jcfg.d_model)).astype(np.float32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jencdec_loss(p, jnp.asarray(frames), jnp.asarray(toks),
                               jcfg), has_aux=True))(params)
    model = _port(params, tcfg)
    tloss, tm = encdec_loss(model, torch.from_numpy(frames),
                            torch.from_numpy(toks), tcfg)
    assert rel(jloss, tloss) < TOL and tm["loss"] is tloss
    assert _grads_rel(jg, _grads(tloss, model), tcfg) < TOL


@pytest.mark.parametrize("arch", ["zamba2-7b", "deepseek-moe-16b", ENCDEC])
def test_remat_matches_no_remat(arch):
    """Checkpointed blocks recompute the same numbers: loss and every
    gradient bit for bit (zamba2's shared block is checkpointed at each of
    its applications)."""
    _, tcfg = _cfgs(arch)
    model = (init_encdec if tcfg.is_encdec else init_lm)(tcfg, 1, "cpu")
    model.requires_grad_(True)
    toks = torch.from_numpy(_tokens(tcfg, 2))
    frames = torch.randn(B, 10, tcfg.d_model, generator=torch.Generator()
                         .manual_seed(3))
    runs = []
    for remat in (True, False):
        if tcfg.is_encdec:
            tot, _ = encdec_loss(model, frames, toks, tcfg, remat=remat)
        else:
            tot, _ = lm_loss(model, toks, tcfg, remat=remat)
        runs.append((tot, _grads(tot, model)))
    (t1, g1), (t2, g2) = runs
    assert torch.equal(t1, t2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_forward_last_position_matches_prefill(arch):
    _, tcfg = _cfgs(arch)
    model = init_lm(tcfg, 4, "cpu")
    toks = torch.from_numpy(_tokens(tcfg, 5))
    with torch.no_grad():
        logits, aux = lm_forward(model, toks, tcfg)
        last, _ = lm_prefill(model, toks, tcfg, S)
    assert logits.shape == (B, S, tcfg.vocab_size)
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert rel(last[:, 0], logits[:, -1]) < TOL


def test_serving_models_track_no_gradients():
    cfg = tconfigs.reduced_config("qwen2-1.5b")
    model = init_lm(cfg, 0, "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    enc = init_encdec(tconfigs.reduced_config(ENCDEC), 0, "cpu")
    assert not any(p.requires_grad for p in enc.parameters())
    logits, _ = lm_prefill(model, torch.zeros((1, 4), dtype=torch.long),
                           cfg, 8)
    assert not logits.requires_grad
    trained, _ = make_train_state(cfg, 0, "cpu")
    assert all(p.requires_grad for p in trained.parameters())
    with pytest.raises(NotImplementedError):
        pipeline_train_step(None, None, None, cfg, TrainConfig(), None, 2)
