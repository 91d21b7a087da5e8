"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX package's
``moe_mlp`` on the CPU: the same seeded weights (``init_moe``, carried
across) and NumPy inputs, output and Switch aux loss at float32 within
relative 1e-4, at the reduced MoE configs and with capacity tight enough
to drop tokens.  Routing is compared at float32: ``torch.topk`` and
``jax.lax.top_k`` may order exact ties differently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, cpu_gen, load, perturb, rel
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe


def _case(arch: str, **changes):
    cfg = dataclasses.replace(jconfigs.reduced_config(arch),
                              dtype="float32", **changes)
    p = perturb(jmoe.init_moe(jax.random.PRNGKey(4), cfg), 4)
    return cfg, p, load(tmoe.MoE(cfg, cpu_gen()), p)


CASES = {
    "deepseek": ("deepseek-moe-16b", {}),          # 2 shared experts
    "phi": ("phi3.5-moe-42b-a6.6b", {}),
    # 6 of 8 experts over 35 tokens in groups of 7: a capacity of 3 drops
    "drops": ("deepseek-moe-16b", dict(n_experts=8, top_k=6,
                                       router_group_size=8,
                                       capacity_factor=0.5)),
    "top1": ("phi3.5-moe-42b-a6.6b", dict(top_k=1, router_group_size=5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_reference(case):
    arch, changes = CASES[case]
    cfg, p, mod = _case(arch, **changes)
    x = np.random.default_rng(5).normal(0, 1, (5, 7, cfg.d_model)) \
        .astype(np.float32)
    jout, jaux = jmoe.moe_mlp(p, jnp.asarray(x), cfg)
    with torch.inference_mode():
        tout, taux = tmoe.moe_mlp(mod, torch.from_numpy(x), cfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    assert rel(jout, tout) < TOL
    assert abs(float(jaux) - float(taux)) <= TOL * abs(float(jaux))
    assert hasattr(mod, "shared") == bool(cfg.n_shared_experts)


def test_moe_drops_past_capacity():
    """The drops case really drops: its output differs from the same
    routing at ample capacity, and both match the reference."""
    arch, changes = CASES["drops"]
    x = np.random.default_rng(6).normal(0, 1, (5, 7, 128)).astype(np.float32)
    outs = []
    for factor in (0.5, 8.0):
        cfg, p, mod = _case(arch, **dict(changes, capacity_factor=factor))
        with torch.inference_mode():
            tout, _ = tmoe.moe_mlp(mod, torch.from_numpy(x), cfg)
        assert rel(jmoe.moe_mlp(p, jnp.asarray(x), cfg)[0], tout) < TOL
        outs.append(tout)
    assert rel(outs[1], outs[0]) > 1e-2


@pytest.mark.parametrize("tokens,group,want", [(35, 8, 7), (4095, 1024, 819),
                                                (1, 64, 1), (128, 1024, 128),
                                                (97, 64, 1)])
def test_group_size_is_the_largest_divisor(tokens, group, want):
    assert tmoe.group_size(tokens, group) == want


def test_moe_bf16_runs_close():
    """bf16 weights and activations: within the reference's bf16 bound
    (relative 3e-2) on inputs away from routing ties."""
    cfg = jconfigs.reduced_config("deepseek-moe-16b")
    p = jmoe.init_moe(jax.random.PRNGKey(7), cfg)
    mod = load(tmoe.MoE(cfg, cpu_gen()), p)
    x = np.random.default_rng(8).normal(0, 1, (2, 3, cfg.d_model))
    jout, _ = jmoe.moe_mlp(p, jnp.asarray(x, jnp.bfloat16), cfg)
    with torch.inference_mode():
        tout, _ = tmoe.moe_mlp(mod, torch.from_numpy(x).bfloat16(), cfg)
    assert tout.dtype == torch.bfloat16 and rel(jout, tout) < 3e-2
