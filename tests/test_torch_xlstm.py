"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's on the CPU, with the reference's ``init_mlstm`` / ``init_slstm``
weights (constant leaves given seeded values) carried across: mLSTM's
quadratic and chunkwise forms and its decode recurrence, sLSTM's scan and
decode; float32 within relative 1e-4.  The chunkwise form is also held to
the quadratic form, as ``tests/test_models.py`` holds the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, cpu_gen, load, perturb, rel
from repro import configs as jconfigs
from repro.models import xlstm as jx
from repro_torch.models import xlstm as tx

CFG = dataclasses.replace(jconfigs.reduced_config("xlstm-1.3b"),
                          dtype="float32")


@pytest.fixture(scope="module")
def mlstm():
    p = perturb(jx.init_mlstm(jax.random.PRNGKey(12), CFG), 12)
    return p, load(tx.MLSTM(CFG, cpu_gen()), p)


@pytest.fixture(scope="module")
def slstm():
    p = perturb(jx.init_slstm(jax.random.PRNGKey(13), CFG), 13)
    return p, load(tx.SLSTM(CFG, cpu_gen()), p)


def _x(seed: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (2, s, CFG.d_model)) \
        .astype(np.float32)


def test_mlstm_block_matches_reference(mlstm):
    p, mod = mlstm
    x = _x(14, 23)
    with torch.inference_mode():
        got = tx.mlstm_block(mod, torch.from_numpy(x), CFG)
    assert rel(jx.mlstm_block(p, jnp.asarray(x), CFG), got) < TOL


@pytest.mark.parametrize("s,chunk", [(40, 16), (32, 8), (9, 16)])
def test_mlstm_block_chunked_matches_reference(mlstm, s, chunk):
    """Against the reference's chunkwise form, and against the quadratic
    form (both packages')."""
    p, mod = mlstm
    x = _x(s, s)
    with torch.inference_mode():
        got = tx.mlstm_block_chunked(mod, torch.from_numpy(x), CFG, chunk)
        quad = tx.mlstm_block(mod, torch.from_numpy(x), CFG)
    assert rel(jx.mlstm_block_chunked(p, jnp.asarray(x), CFG, chunk),
               got) < TOL
    assert rel(quad, got) < 1e-3


def test_mlstm_decode_matches_reference(mlstm):
    p, mod = mlstm
    x = _x(15, 4)
    js, ts = jx.mlstm_init_state(CFG, 2), tx.mlstm_init_state(CFG, 2, "cpu")
    with torch.inference_mode():
        for t in range(4):
            jy, js = jx.mlstm_decode(p, jnp.asarray(x[:, t:t + 1]), CFG, js)
            ty, ts = tx.mlstm_decode(mod, torch.from_numpy(x[:, t:t + 1]),
                                     CFG, ts)
            assert rel(jy, ty) < TOL
            for k in ("C", "n", "m"):
                assert ts[k].shape == js[k].shape and rel(js[k], ts[k]) < TOL


def test_slstm_block_matches_reference(slstm):
    p, mod = slstm
    x = _x(16, 11)
    with torch.inference_mode():
        got = tx.slstm_block(mod, torch.from_numpy(x), CFG)
    assert rel(jx.slstm_block(p, jnp.asarray(x), CFG), got) < TOL


def test_slstm_decode_matches_reference(slstm):
    """Decode steps from the initial state (m = -1e30), and their outputs
    equal the scan's."""
    p, mod = slstm
    x = _x(17, 4)
    js, ts = jx.slstm_init_state(CFG, 2), tx.slstm_init_state(CFG, 2, "cpu")
    assert bool((ts["m"] == torch.tensor(-1e30)).all())
    ys = []
    with torch.inference_mode():
        for t in range(4):
            jy, js = jx.slstm_decode(p, jnp.asarray(x[:, t:t + 1]), CFG, js)
            ty, ts = tx.slstm_decode(mod, torch.from_numpy(x[:, t:t + 1]),
                                     CFG, ts)
            assert rel(jy, ty) < TOL
            for k in ("c", "n", "h", "m"):
                assert rel(js[k], ts[k]) < TOL
            ys.append(ty)
        scan = tx.slstm_block(mod, torch.from_numpy(x), CFG)
    assert rel(scan, torch.cat(ys, 1)) < TOL
