"""The port's offload planner (``repro_torch.core.offload``) on the CPU:
``plan_offload`` against the JAX package's on the same traces (the
reference's ``jaxpr_trace`` of the two functions of
``tests/test_serve_offload.py``, and the port's ``fx_trace`` of a reduced
stablelm-3b gradient), fed to both as lists, at an unbounded budget, 2/3
and 1/2 of the peak: every ``OffloadPlan`` field and every move equal; and
``fx_trace``'s own contract: every buffer an instruction reads is an input
or was written before, one instruction a graph call, each size its fake
tensor's bytes."""

import dataclasses
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.configs import reduced_config as jreduced_config
from repro.core import offload as joff
from repro.models import init_lm as jinit_lm, lm_loss as jlm_loss
from repro_torch.configs import reduced_config
from repro_torch.core import offload as toff
from repro_torch.models import init_lm, lm_loss

ARCH = "stablelm-3b"


def _mlp(x, w1, w2, w3):
    """The reference test's small function, for either package."""
    relu = jax.nn.relu if isinstance(x, jax.Array) else torch.relu
    a = x @ w1
    b = relu(a)
    c = b @ w2
    d = relu(c)
    e = d @ w3
    return (a * 0).sum() + e.sum() + (b * 0).sum()


def _port_grad_trace():
    cfg = reduced_config(ARCH)
    model = init_lm(cfg, 0, "cpu")
    fn, params = toff.loss_grad(
        model, lambda m, t: lm_loss(m, t, cfg, remat=False)[0])
    return fn, params, torch.zeros((2, 16), dtype=torch.long)


@pytest.fixture(scope="module")
def traces():
    """name -> (sizes, reads, writes, names) as lists."""
    out = {}
    x = jnp.zeros((128, 256))
    ws = [jnp.zeros((256, 256)) for _ in range(3)]
    out["ref mlp"] = joff.jaxpr_trace(_mlp, x, *ws)
    jcfg = jreduced_config(ARCH)
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    toks = jnp.zeros((2, 16), dtype=jnp.int32)
    out["ref grad"] = joff.jaxpr_trace(
        jax.grad(lambda p: jlm_loss(p, toks, jcfg)[0]), params)
    fn, tparams, ttoks = _port_grad_trace()
    out["port grad"] = toff.fx_trace(fn, tparams, ttoks)
    return {k: (list(t.sizes), [list(r) for r in t.reads],
                [list(w) for w in t.writes], list(t.names))
            for k, t in out.items()}


@pytest.mark.parametrize("frac", [None, (2, 3), (1, 2)],
                         ids=["unbounded", "2/3", "1/2"])
@pytest.mark.parametrize("name", ["ref mlp", "ref grad", "port grad"])
def test_plan_offload_matches_reference(traces, name, frac):
    lists = traces[name]
    peak = joff.plan_offload(joff.BufferTrace(*lists), 1 << 40).peak_unbounded
    budget = 1 << 40 if frac is None else frac[0] * peak // frac[1]
    want = joff.plan_offload(joff.BufferTrace(*lists), budget)
    got = toff.plan_offload(toff.BufferTrace(*lists), budget)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if frac is None:
        assert got.feasible and got.bytes_out == 0 and not got.moves
    else:
        assert got.bytes_out > 0 and got.bytes_in > 0
        assert got.bytes_out <= sum(lists[0])
    assert got.est_overhead(compute_s=1.0) == want.est_overhead(
        compute_s=1.0) >= 0.0
    assert got.est_overhead(123e9) == want.est_overhead(123e9)


def test_fx_trace_contract():
    fn, params, toks = _port_grad_trace()
    gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(
        params, toks)
    tr = toff.graph_trace(gm.graph)
    assert tr == toff.fx_trace(fn, params, toks)
    nodes = list(gm.graph.nodes)
    calls = [n for n in nodes if n.op == "call_function"
             and n.target is not operator.getitem]
    inputs = [n for n in nodes if n.op == "placeholder"]
    consts = {n.target: n for n in nodes if n.op == "get_attr"}
    n_in = len(inputs) + len(consts)
    # one instruction a call, named by its ATen op
    assert tr.names == [str(n.target) for n in calls]
    assert all(name.startswith("aten.") for name in tr.names)
    # the inputs are the parameters, the tokens and the constants
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert tr.sizes[:len(inputs)] == \
        [nbytes(p) for p in params.values()] + [nbytes(toks)]
    assert tr.sizes[len(inputs):n_in] == \
        [nbytes(n.meta["val"]) for n in consts.values()]
    # every write is a new buffer in order, every read an earlier one
    seen = set(range(n_in))
    nxt = n_in
    for r, w in zip(tr.reads, tr.writes):
        assert set(r) <= seen
        assert w == list(range(nxt, nxt + len(w)))
        nxt += len(w)
        seen.update(w)
    assert nxt == len(tr.sizes)
    # the sizes are the fake tensors' bytes
    outs = []
    for n in calls:
        val = n.meta["val"]
        vals = val if isinstance(val, (list, tuple)) else [val]
        outs += [nbytes(v) for v in vals if isinstance(v, torch.Tensor)]
    assert tr.sizes[n_in:] == outs
    # the gradient is the output: one tensor a parameter, by name
    grads = gm(params, toks)
    assert list(grads) == list(params)
    assert all(grads[k].shape == params[k].shape for k in params)


def test_fx_trace_of_the_small_function():
    x = torch.zeros((128, 256))
    ws = [torch.zeros((256, 256)) for _ in range(3)]
    tr = toff.fx_trace(_mlp, x, *ws)
    assert tr.sizes[:4] == [128 * 256 * 4] + [256 * 256 * 4] * 3
    assert "aten.mm.default" in tr.names and "aten.relu.default" in tr.names
    unbounded = toff.plan_offload(tr, budget_bytes=1 << 40)
    assert unbounded.bytes_out == 0 and unbounded.feasible
    tight = toff.plan_offload(tr, 2 * unbounded.peak_unbounded // 3)
    assert tight.feasible and tight.bytes_out > 0 and tight.bytes_in > 0
    assert tight.bytes_out <= sum(tr.sizes)
    assert np.isclose(tight.est_overhead(1e9),
                      (tight.bytes_in + tight.bytes_out) / 1e9)
