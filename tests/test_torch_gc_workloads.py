"""The port's GC workloads and apps against the JAX package's Session on the
CPU, at small sizes: ljoin, binfclayer and pir two-party on the batched
and the scalar loop (mvmul, passreuse and sort have files of their own,
for time); every GC workload through the plaintext oracle driver (outputs
and the final engine memory, bit for bit); a workload that emits every
batched GC op, in the clear at 64 bits with bit 63 set and two-party at 16
bits; the reference's ljoin plan run in the port; the runner (also at two
workers); and every workload's two-worker traces against the JAX
package's (passreuse asserts one worker in both)."""

import numpy as np
import pytest

from _torch_gc_jobs import (assert_plaintext_matches,
                            assert_two_party_matches, job,
                            reference_plaintext, same_outputs)
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import Op as RefOp, encode_chunk as ref_encode
from repro.protocols.garbled.dsl import Integer as RefInteger, \
    Party as RefParty
from repro.workloads.base import Workload as RefWorkload
from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import Op, encode_chunk
from repro_torch.core.planner import PlanConfig
from repro_torch.interop import program_from_records
from repro_torch.protocols.garbled.dsl import Integer, Party
from repro_torch.workloads import all_names, get
from repro_torch.workloads import runner
from repro_torch.workloads.base import Workload
from repro_torch.workloads.ckks_workloads import PARAMS

BACKENDS = ["batched", "scalar"]
GC_WORKLOADS = ["merge", "sort", "ljoin", "mvmul", "binfclayer", "passreuse"]


def test_registry_holds_every_workload():
    assert all_names() == sorted(GC_WORKLOADS + [
        "rsum", "rstats", "rmvmul", "n_rmatmul", "t_rmatmul", "pir",
        "shamir_stats", "shamir_cmp"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wl", ["ljoin", "binfclayer"])
def test_two_party_matches_reference(wl, backend):
    assert_two_party_matches(wl, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pir_matches_reference(backend):
    """pir at ring 128 (64 slots, where both packages draw the same data):
    outputs bit for bit, checked against the oracle."""
    spec = job("pir")
    ref_out = RefSession(RefJobSpec(workload="pir", exec_backend=backend,
                                    **spec)).execute(check=True)
    s = Session(JobSpec("pir", exec_backend=backend, **spec), device="cpu")
    assert same_outputs(s.execute(check=True), ref_out)
    assert s.ckks_counts["ntt_forward"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wl", GC_WORKLOADS)
def test_plaintext_matches_reference(wl, backend):
    assert_plaintext_matches(wl, backend)


def test_plaintext_unbounded_matches_reference():
    assert_plaintext_matches("ljoin", "batched", n=16, plan_mode="unbounded")


# ---------------------------------------------------------------------------
# every batched op: the same DSL program written for both packages
# ---------------------------------------------------------------------------

ALL_N = 4              # elements a value (a power of two: sort_local)
ALL_GROUPS = 3         # independent copies of each op, which batch


def _all_ops_build(integer, party, op):
    def build(opts):
        w = opts.extra["width"]
        xs = [integer(w, ALL_N).mark_input(party.Garbler, i)
              for i in range(ALL_GROUPS)]
        ys = [integer(w, ALL_N).mark_input(party.Evaluator, 100 + i)
              for i in range(ALL_GROUPS)]
        res = []
        for x, y in zip(xs, ys):
            ge = x >= y
            res += [x + y, x - y, x * y, x ^ y, x & y, x | y, ~x, ge, x == y,
                    x.cmp_ge(y, w // 2), x.cmp_eq(y, w // 2),
                    ge.select(x, y), *x.minmax(y, w), *x.minmax(y, w // 2),
                    x.sort_local(w), x.sort_local(w, descending=True),
                    x.reverse(),
                    x.reduce_add(), x.pair_join(y, w // 2)]
            c = integer(w, ALL_N)
            x.builder.emit(op.COPY, outs=(c.span,), ins=(x.span,))
            res.append(c)
        for t, v in enumerate(res):
            v.mark_output(1000 + t)
    return build


def _all_ops_values(tag: int) -> np.ndarray:
    v = np.random.default_rng(tag).integers(
        0, np.iinfo(np.uint64).max, ALL_N, dtype=np.uint64)
    v[0] |= np.uint64(1 << 63)              # keys with bit 63 set
    return v


def _all_ops_inputs(width: int):
    mask = np.uint64((1 << width) - 1 if width < 64 else 2**64 - 1)
    low = np.uint64((1 << (width // 2)) - 1)

    def provider(tag: int) -> np.ndarray:
        v = _all_ops_values(tag)
        if tag >= 100:       # y beside x: one element equal, one key equal
            x = _all_ops_values(tag - 100)
            v[1] = x[1]
            v[2] = (v[2] & ~low) | (x[2] & low)
        return v & mask
    return lambda n, worker, p: provider


def _all_ops(width: int) -> tuple:
    """The all-ops workload in both packages, at ``width`` bits."""
    inputs = _all_ops_inputs(width)
    params = {"width": width}
    return (RefWorkload("allops", "gc", _all_ops_build(RefInteger, RefParty,
                                                       RefOp),
                        inputs, lambda n: {}, default_n=ALL_N, params=params),
            Workload("allops", "gc", _all_ops_build(Integer, Party, Op),
                     inputs, lambda n: {}, default_n=ALL_N, params=params))


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_op_in_the_clear_at_64_bits(backend):
    """Unsigned compares, sorts and shifts on int64 bit views: keys with
    bit 63 set, a 64-bit mask, logical shifts in PAIR_JOIN."""
    ref_w, port_w = _all_ops(64)
    s = assert_plaintext_matches("allops", backend, ref_w, port_w,
                                 check=False, n=ALL_N, memory_budget=8,
                                 prefetch_pages=1)
    if backend == "batched":
        assert s.engine_stats[0].batched_instructions > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_op_two_party(backend):
    ref_w, port_w = _all_ops(16)
    s = assert_two_party_matches("allops", backend, ref_w, port_w,
                                 check=False, n=ALL_N, plan_mode="unbounded")
    if backend == "batched":
        assert s.engine_stats[0].batched_instructions > 0
    plain = Session(JobSpec("allops", n=ALL_N, plan_mode="unbounded",
                            exec_backend=backend), device="cpu",
                    workload=port_w).execute(real=False)
    assert same_outputs(s.engines[1].driver.outputs, plain)


# ---------------------------------------------------------------------------
# SORT_LOCAL on repeated keys: the plaintext drivers' stable sort
# ---------------------------------------------------------------------------

TIE_N = 8              # elements a value (a power of two)


def _ties_build(integer, party):
    def build(opts):
        xs = [integer(64, TIE_N).mark_input(party.Garbler, g)
              for g in range(ALL_GROUPS)]
        res = [x.sort_local(kw, descending=desc) for kw in (32, 64)
               for desc in (False, True) for x in xs]
        for t, v in enumerate(res):
            v.mark_output(1000 + t)
    return build


def _ties_inputs(n, worker, p):
    """Keys (the low 32 bits) from {0, 1, 2^31 + 5}, payloads all
    different: every key repeats, and the records of one key differ.  Two
    records are equal in all 64 bits, bit 63 set in both."""
    def provider(tag: int) -> np.ndarray:
        rng = np.random.default_rng(tag)
        keys = rng.choice(np.array([0, 1, (1 << 31) + 5], dtype=np.uint64),
                          TIE_N)
        pay = rng.permutation(TIE_N).astype(np.uint64) << np.uint64(40)
        v = keys | pay
        v[1] = v[0] = v[0] | np.uint64(1 << 63)
        return v
    return provider


@pytest.mark.parametrize("backend", BACKENDS)
def test_plaintext_sort_of_equal_keys_matches_reference(backend):
    """Ascending and descending, on a 32-bit key of 64-bit records whose
    keys repeat and on the whole 64 bits: outputs and final engine memory
    equal the JAX package's gc-plaintext, whose SORT_LOCAL is a stable
    argsort (reversed when descending)."""
    ref_w = RefWorkload("ties", "gc", _ties_build(RefInteger, RefParty),
                        _ties_inputs, lambda n: {}, default_n=TIE_N)
    port_w = Workload("ties", "gc", _ties_build(Integer, Party),
                      _ties_inputs, lambda n: {}, default_n=TIE_N)
    s = assert_plaintext_matches("ties", backend, ref_w, port_w,
                                 check=False, n=TIE_N, memory_budget=8,
                                 prefetch_pages=1)
    if backend == "batched":
        assert s.engine_stats[0].batched_instructions > 0


def test_plaintext_sort_at_fig8_size_matches_reference():
    """sort n=16384 unbounded (chip_smoke.py's plaintext job) equals the
    JAX package's gc-plaintext: outputs and final engine memory.  Both
    differ from the oracle, which sorts the input stably, in the order of
    one pair of records with equal keys: the merge network's compare-
    exchanges order equal keys otherwise than a stable sort."""
    spec = dict(n=16384, plan_mode="unbounded")
    assert_plaintext_matches("sort", "batched", check=False, **spec)
    ref_out, _ = reference_plaintext("sort", "batched", **spec)
    want = get("sort").oracle(16384)
    assert sorted(ref_out) == sorted(want)
    got = np.concatenate([ref_out[k] for k in sorted(want)])
    exp = np.concatenate([want[k] for k in sorted(want)])
    key = np.uint64((1 << 32) - 1)
    assert np.array_equal(got & key, exp & key)
    assert np.array_equal(np.sort(got), np.sort(exp))
    assert (got != exp).sum() == 2


# ---------------------------------------------------------------------------
# interop, runner, CLI, refusals
# ---------------------------------------------------------------------------


def test_reference_ljoin_plan_runs_in_port():
    ref = RefSession(RefJobSpec(workload="ljoin", plan_core="scalar",
                                **job("ljoin")))
    rm = ref.plan()[0]
    header = {k: getattr(rm, k) for k in ("page_shift", "phase",
                                          "num_frames", "prefetch_slots",
                                          "vspace_slots", "meta")}
    prog = program_from_records(ref_encode(rm.instrs), header)
    s = Session(JobSpec("ljoin", **job("ljoin")), device="cpu")
    s.adopt_plan([prog])
    s.execute(real=True, check=True)
    assert all(e.swap_ins > 0 for e in s.engine_stats)


def test_runner_runs_each_mode():
    w = get("binfclayer")
    cfg = PlanConfig(num_frames=4, lookahead=10_000, prefetch_pages=1)
    want = w.oracle(128)
    for out in (runner.run(w, 128, device="cpu"),
                runner.run(w, 128, cfg=cfg, device="cpu"),
                runner.run_gc_real(w, 128, cfg=cfg, device="cpu")):
        runner.check_against_oracle(w, 128, out)
        assert same_outputs(out, want)
    pir = get("pir")
    out = runner.run(pir, 16, params=PARAMS, device="cpu")
    runner.check_against_oracle(pir, 16, out)
    # two workers a party, each taking half the rows
    out = runner.run(w, 128, num_workers=2, device="cpu")
    runner.check_against_oracle(w, 128, out)
    assert same_outputs(out, want)


@pytest.mark.parametrize("wl", GC_WORKLOADS + ["pir"])
def test_multi_worker_traces_name_their_roadmap_item(wl):
    """Two workers a party trace what the JAX package traces, worker for
    worker, record for record; passreuse's merge asserts a single worker
    in both packages."""
    n = job(wl)["n"]
    if wl == "passreuse":
        with pytest.raises(AssertionError):
            get(wl).trace(n, num_workers=2)
        with pytest.raises(AssertionError):
            RefSession(RefJobSpec(workload=wl, n=n, num_workers=2,
                                  plan_mode="unbounded")).trace()
        return
    ref = RefSession(RefJobSpec(workload=wl, n=n, num_workers=2,
                                plan_mode="unbounded")).trace()
    port = get(wl).trace(n, num_workers=2)
    assert len(port) == len(ref) == 2
    for pv, rv in zip(port, ref):
        assert (pv.worker, pv.num_workers, pv.vspace_slots) == \
            (rv.worker, rv.num_workers, rv.vspace_slots)
        assert np.array_equal(encode_chunk(pv.instrs), ref_encode(rv.instrs))


def test_cli_runs_new_workloads_in_the_clear(capsys):
    assert cli.main(["exec", "--workload", "mvmul", "-n", "32", "--budget",
                     "4", "--prefetch", "1", "--check", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"driver": "gc-plaintext"' in out and '"checked": true' in out
