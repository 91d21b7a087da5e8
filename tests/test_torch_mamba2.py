"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's on the CPU: ``_ssd_chunked`` on NumPy inputs over one and several
chunks, ``_causal_conv`` in both forms, ``mamba2_block`` (padded to whole
chunks and not) and ``mamba2_decode`` steps, with the reference's
``init_mamba2`` weights (zero biases given seeded values) carried across;
float32 within relative 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, cpu_gen, load, perturb, rel
from repro import configs as jconfigs
from repro.models import mamba2 as jm
from repro_torch.models import mamba2 as tm

CFG = dataclasses.replace(jconfigs.reduced_config("zamba2-7b"),
                          dtype="float32")


@pytest.fixture(scope="module")
def weights():
    p = perturb(jm.init_mamba2(jax.random.PRNGKey(9), CFG), 9)
    return p, load(tm.Mamba2(CFG, cpu_gen()), p)


@pytest.mark.parametrize("s,chunk", [(16, 16), (48, 16), (40, 8), (7, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    b, nh, P, n = 2, 3, 8, 5
    x = rng.normal(0, 1, (b, s, nh, P)).astype(np.float32)
    dtv = rng.uniform(0.01, 0.5, (b, s, nh)).astype(np.float32)
    B = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    want = jm._ssd_chunked(*map(jnp.asarray, (x, dtv, B, C, a_log)), chunk)
    got = tm._ssd_chunked(*map(torch.from_numpy, (x, dtv, B, C, a_log)),
                          chunk)
    assert got.shape == (b, s, nh, P) and rel(want, got) < TOL


def test_causal_conv_matches_reference(weights):
    p, mod = weights
    _, _, n = tm.dims(CFG)
    ch = 2 * CFG.d_model + 2 * n
    rng = np.random.default_rng(10)
    xbc = rng.normal(0, 1, (2, 9, ch)).astype(np.float32)
    state = rng.normal(0, 1, (2, tm.CONV_K - 1, ch)).astype(np.float32)
    j, _ = jm._causal_conv(p, jnp.asarray(xbc))
    t, _ = tm._causal_conv(mod, torch.from_numpy(xbc))
    assert rel(j, t) < TOL
    j, js = jm._causal_conv(p, jnp.asarray(xbc[:, :1]), jnp.asarray(state))
    t, ts = tm._causal_conv(mod, torch.from_numpy(xbc[:, :1]),
                            torch.from_numpy(state))
    assert rel(j, t) < TOL and rel(js, ts) == 0.0


@pytest.mark.parametrize("s", [16, 40, 5])
def test_mamba2_block_matches_reference(weights, s):
    """s = 40 pads to 48 (chunk 16) and cuts back; s = 5 is one short
    chunk."""
    p, mod = weights
    x = np.random.default_rng(s).normal(0, 1, (2, s, CFG.d_model)) \
        .astype(np.float32)
    with torch.inference_mode():
        got = tm.mamba2_block(mod, torch.from_numpy(x), CFG)
    assert got.shape == x.shape
    assert rel(jm.mamba2_block(p, jnp.asarray(x), CFG), got) < TOL


def test_mamba2_decode_matches_reference(weights):
    """Five decode steps from the initial state: outputs and both state
    leaves; and the steps' outputs equal the block's over the same
    tokens (the recurrence is the chunked scan's)."""
    p, mod = weights
    x = np.random.default_rng(11).normal(0, 1, (2, 5, CFG.d_model)) \
        .astype(np.float32)
    js = jm.mamba2_init_state(CFG, 2)
    ts = tm.mamba2_init_state(CFG, 2, "cpu")
    assert {k: v.shape for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}
    ys = []
    with torch.inference_mode():
        for t in range(5):
            jy, js = jm.mamba2_decode(p, jnp.asarray(x[:, t:t + 1]), CFG, js)
            ty, ts = tm.mamba2_decode(mod, torch.from_numpy(x[:, t:t + 1]),
                                      CFG, ts)
            assert rel(jy, ty) < TOL
            for k in ("h", "conv"):
                assert rel(js[k], ts[k]) < TOL
            ys.append(ty)
        block = tm.mamba2_block(mod, torch.from_numpy(x), CFG)
    assert rel(block, torch.cat(ys, 1)) < 1e-3
