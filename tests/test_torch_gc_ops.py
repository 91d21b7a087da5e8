"""The port's AND-XOR subcircuits against the JAX package's, gate for gate:
each ``AndXorOps`` method runs on the reference's NumPy garbler and
evaluator and on the port's (the plain half gates on the CPU) from one
seed and the same input bits.  Garbler labels, evaluator labels, every
garbled table in order, the messages of each kind and the final gate ids
must be equal bit for bit.  Widths 1, 8 and 32; odd element counts where
the subcircuit takes any."""

import hashlib

import numpy as np
import pytest
import torch

from repro.protocols.garbled.engineops import AndXorOps as RefOps
from repro.protocols.garbled.gates import (EvaluatorGates as NpEvaluator,
                                           GarblerGates as NpGarbler,
                                           PartyChannel as NpChannel)
from repro_torch.core.transport import InprocTransport
from repro_torch.protocols.garbled.engineops import AndXorOps
from repro_torch.protocols.garbled.gates import (EvaluatorGates,
                                                 GarblerGates, PartyChannel)

SEED = 7
CPU = torch.device("cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().numpy().view(np.uint64)
    return np.ascontiguousarray(x)


def _tuple(r) -> tuple:
    return r if isinstance(r, tuple) else (r,)


def _reference(name: str, bits: list[np.ndarray], args: tuple):
    tabs = hashlib.sha256()
    ch = NpChannel(depth=0)
    send = ch.send

    def recording_send(kind, arr):
        if kind == "tab":
            tabs.update(np.ascontiguousarray(arr).tobytes())
        send(kind, arr)

    ch.send = recording_send
    g, e = NpGarbler(ch, seed=SEED), NpEvaluator(ch)
    gl = [g.input_garbler(x.reshape(-1)).reshape(*x.shape, 2) for x in bits]
    el = [e.input_garbler(x.size).reshape(*x.shape, 2) for x in bits]
    rg = _tuple(getattr(RefOps(g), name)(*gl, *args))
    re = _tuple(getattr(RefOps(e), name)(*el, *args))
    stats = {k[2]: (v.messages, v.bytes) for k, v in
             ch.transport.stats().items()}
    return rg, re, tabs.hexdigest(), stats, (g.gid, e.gid)


def _port(name: str, bits: list[np.ndarray], args: tuple):
    transport = InprocTransport(2)
    ch = PartyChannel(transport, digest=True)
    transport.set_depth(0, 1, max_msgs=0)    # one thread: no bound
    g, e = GarblerGates(ch, CPU, seed=SEED), EvaluatorGates(ch, CPU)
    gl = [g.input_garbler(x.reshape(-1)).reshape(*x.shape, 2) for x in bits]
    el = [e.input_garbler(x.size).reshape(*x.shape, 2) for x in bits]
    rg = _tuple(getattr(AndXorOps(g), name)(*gl, *args))
    re = _tuple(getattr(AndXorOps(e), name)(*el, *args))
    stats = {k[2]: (v.messages, v.bytes) for k, v in
             transport.stats().items()}
    return rg, re, ch.table_digest(), stats, (g.gid, e.gid)


def _check(name: str, shapes: list[tuple[int, int]], *args, seed: int = 0):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, s, dtype=np.uint8) for s in shapes]
    ref, port = _reference(name, bits, args), _port(name, bits, args)
    for what, r, p in zip(("garbler labels", "evaluator labels"), ref, port):
        assert len(r) == len(p), what
        for x, y in zip(r, p):
            assert np.array_equal(_np(x), _np(y)), what
    assert port[2] == ref[2], "garbled tables differ"
    assert port[3] == ref[3], "messages of each kind differ"
    assert port[4] == ref[4], "gate ids differ"


WIDTHS = [1, 8, 32]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", ["add", "sub", "mul", "cmp_ge", "cmp_eq"])
def test_binary_ops_match_reference(name, w):
    _check(name, [(5, w), (5, w)])


@pytest.mark.parametrize("w", WIDTHS)
def test_add_with_carry_in_and_out(w):
    _check("add", [(3, w), (3, w)], None, True)


@pytest.mark.parametrize("w", WIDTHS)
def test_key_width_below_value_width(w):
    kw = max(w // 2 + 1, 1)
    _check("cmp_eq", [(3, w), (3, w)], kw)
    _check("cmp_ge", [(3, w), (3, w)], kw)


@pytest.mark.parametrize("w", WIDTHS)
def test_select_and_minmax_match_reference(w):
    _check("select", [(5, 1), (5, w), (5, w)])
    _check("minmax", [(5, w), (5, w)], w)


@pytest.mark.parametrize("n", [1, 2, 5, 7])
@pytest.mark.parametrize("w", WIDTHS)
def test_reduce_add_matches_reference(n, w):
    _check("reduce_add", [(n, w)])


@pytest.mark.parametrize("w", [8, 32])
def test_bitonic_merge_and_merge_step_match_reference(w):
    _check("bitonic_merge", [(8, w)], w // 2)
    _check("merge_step", [(4, w), (4, w)], w // 2)


@pytest.mark.parametrize("w,kw", [(1, 1), (8, 3), (32, 8)])
def test_pair_join_matches_reference(w, kw):
    _check("pair_join", [(3, w), (2, w)], kw)


@pytest.mark.parametrize("nr,nj,acc_w", [(3, 5, 32), (1, 2, 17), (3, 1, 32)])
def test_dot8_matches_reference(nr, nj, acc_w):
    _check("dot8", [(nr * nj, 8), (nj, 8), (nr, acc_w)], nr, nj, acc_w)


@pytest.mark.parametrize("w", [1, 8])
def test_mul_widening_and_zext_match_reference(w):
    _check("_mul_widening", [(3, w), (3, w)])
    _check("_zext", [(3, w)], w + 3)
    _check("_zext", [(3, w)], w)


@pytest.mark.parametrize("nr,nj", [(3, 1), (3, 5), (1, 8), (5, 16)])
def test_xnor_pop_sign_matches_reference(nr, nj):
    _check("xnor_pop_sign", [(nr * nj, 1), (nj, 1)], nr, nj)
