"""The port's n-party Shamir protocol against the JAX package's, on the CPU.

* The GF(2^61 - 1) field on int64 tensors: ``fold``, ``addmod`` and
  ``submod`` bit for bit against the reference's uint64 NumPy arithmetic
  at 0, 1, p-1, p, 2^61, 2^63, 2^64-1 and seeded random words (any 64-bit
  word), ``mulmod`` and ``mulmod_scalar`` on canonical residues;
  ``prf_coeffs``, ``share`` / ``reconstruct``, the Lagrange weights and
  ``inverse`` equal the reference's.
* The DSL traces and the vectorized record builders equal the
  reference's DSL traces by ``records_digest`` at 3 and 5 parties, and the
  program writers write them.
* ``shamir_stats`` n=1024 and ``shamir_cmp`` n=512 at 3 and 5 parties,
  planned at budget 0.5, on the scalar, batched and overlap loops:
  outputs equal the oracle and the reference's, every rank's final
  engine memory equals the reference's (as uint64), and the NET messages
  and bytes of every worker link are equal.
* The drivers' validation, the fixed-party drivers, ``driver="auto"``,
  the CLI (``exec``, ``plan`` / ``run --driver shamir-3party``) and
  ``measure_traffic`` over the shaped transport.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import repro.core.transport as ref_transport
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import encode_chunk as ref_encode
from repro.core.bytecode import strip_frees as ref_strip_frees
from repro.core.engine import Engine as RefEngine
from repro.protocols.shamir import driver as ref_driver
from repro.protocols.shamir import field as ref_field
from repro.workloads import get as ref_get
from repro_torch import __main__ as cli
from repro_torch import scenarios as sc
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import (Op, ProgramFile, encode_chunk,
                                       strip_frees)
from repro_torch.core.liveness import records_digest
from repro_torch.core.transport import FabricSpec, aggregate_links
from repro_torch.protocols.shamir import ShamirDriver, field
from repro_torch.workloads import get
from repro_torch.workloads import shamir_workloads as sw

P = field.P
EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 31) - 1, 1 << 31,
         1 << 61, (1 << 62) + 5, 1 << 63, (1 << 63) + 1, (1 << 64) - 1]
#: canonical residues: the products' contract, in both packages
RESIDUES = [0, 1, 2, P - 2, P - 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
            (1 << 60) + 12345, P // 2, P // 3]


def _words(seed: int = 0, m: int = 96, canonical: bool = False
           ) -> np.ndarray:
    """Edge words and seeded random ones: any 64-bit word, or residues."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, P, m, dtype=np.uint64)
    if canonical:
        return np.concatenate([np.array(RESIDUES, dtype=np.uint64), res])
    rand = rng.integers(0, 1 << 64, m, dtype=np.uint64, endpoint=False)
    return np.concatenate([np.array(EDGES, dtype=np.uint64), rand, res])


def _port(fn, *args):
    return field.to_numpy(fn(*[field.as_tensor(a) for a in args]))


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["addmod", "submod", "mulmod"])
def test_binary_field_ops_bit_for_bit(name, seed):
    w = _words(seed, canonical=name == "mulmod")
    a, b = np.repeat(w, len(w)), np.tile(w, len(w))
    want = getattr(ref_field, name)(a, b)
    got = _port(getattr(field, name), a, b)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert (got < P).all()


@pytest.mark.parametrize("seed", range(3))
def test_fold_and_mulmod_scalar_bit_for_bit(seed):
    w = _words(seed)
    assert np.array_equal(_port(field.fold, w), ref_field.fold(w))
    w = _words(seed, canonical=True)
    for c in (0, 1, 2, P - 1, P, 1 << 61, (1 << 64) - 1, 0x9E3779B9):
        got = field.to_numpy(field.mulmod_scalar(field.as_tensor(w), c))
        assert np.array_equal(got, ref_field.mulmod_scalar(w, c)), c


def test_field_ops_match_python_ints():
    rng = np.random.default_rng(5)
    a = rng.integers(0, P, 256, dtype=np.uint64)
    b = rng.integers(0, P, 256, dtype=np.uint64)
    got = _port(field.mulmod, a, b)
    assert [int(x) for x in got] == \
        [int(x) * int(y) % P for x, y in zip(a, b)]
    assert [int(x) for x in _port(field.submod, a, b)] == \
        [(int(x) - int(y)) % P for x, y in zip(a, b)]


@pytest.mark.parametrize("key", [0, 1, ref_driver.SEED_INPUT,
                                 ref_driver.SEED_RESHARE ^ 3 * 0x9E3779B9,
                                 (1 << 64) - 1])
def test_prf_coeffs_equal_reference(key):
    for a, b, count in ((0, 0, 1), (7, 1, 256), ((1 << 16) + 3, 2, 1000),
                        ((1 << 63) + 1, (1 << 64) - 1, 33)):
        got = field.prf_coeffs(key, a, b, count)
        assert got.dtype == np.uint64 and (got < P).all()
        assert np.array_equal(got, ref_field.prf_coeffs(key, a, b, count))


@pytest.mark.parametrize("n_parties,t", [(3, 1), (5, 2), (7, 3)])
def test_share_reconstruct_and_weights(n_parties, t):
    secrets = np.concatenate([np.array(EDGES, dtype=np.uint64),
                              np.arange(50, dtype=np.uint64)])
    got = field.share(secrets, n_parties, t, np.random.default_rng(9))
    want = ref_field.share(secrets, n_parties, t, np.random.default_rng(9))
    assert np.array_equal(got, want)
    canon = secrets % np.uint64(P)
    assert np.array_equal(field.reconstruct(got), canon)
    parties = list(range(n_parties - t - 1, n_parties))
    assert np.array_equal(field.reconstruct(got[parties], parties), canon)
    assert np.array_equal(field.reconstruct(got[parties], parties),
                          ref_field.reconstruct(want[parties], parties))
    assert field.lagrange_at_zero(n_parties) == \
        ref_field.lagrange_at_zero(n_parties)
    with pytest.raises(ValueError, match="party ids"):
        field.reconstruct(got[:2], [0])


def test_inverse_and_eval_points():
    for x in (1, 2, 3, P - 1, 12345678901234567):
        assert field.inverse(x) == ref_field.inverse(x)
        assert x * field.inverse(x) % P == 1
    with pytest.raises(ZeroDivisionError):
        field.inverse(P)
    assert [field.eval_point(i) for i in range(5)] == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# traces and the vectorized builders
# ---------------------------------------------------------------------------


def _digest(rec: np.ndarray) -> int:
    return records_digest(0, rec, 0)


@pytest.mark.parametrize("num_workers", (3, 5))
@pytest.mark.parametrize("name,n,builder", [
    ("shamir_stats", 1024, sw.build_shamir_stats_records),
    ("shamir_cmp", 512, sw.build_shamir_cmp_records)])
def test_traces_and_builders_equal_reference(name, n, builder, num_workers):
    progs = get(name).trace(n, num_workers=num_workers)
    ref = ref_get(name).trace(n, num_workers=num_workers)
    for worker in range(num_workers):
        want = ref_encode(ref_strip_frees(ref[worker].instrs))
        dsl = encode_chunk(strip_frees(progs[worker].instrs))
        fast = builder(n, worker, num_workers)
        assert _digest(dsl) == _digest(fast) == _digest(want), worker
        assert np.array_equal(fast, want)
        assert progs[worker].vspace_slots == ref[worker].vspace_slots


def test_program_writers(tmp_path):
    progs = get("shamir_stats").trace(1024, num_workers=3)
    for worker in (0, 2):
        pf = sw.write_shamir_stats_program(tmp_path / f"w{worker}.bc", 1024,
                                           worker, 3)
        assert isinstance(pf, ProgramFile)
        assert list(pf.iter_instrs()) == strip_frees(progs[worker].instrs)
        assert pf.vspace_slots == progs[worker].vspace_slots
        assert pf.meta["workload"] == "shamir_stats"
    pf = sw.write_shamir_cmp_program(tmp_path / "c.bc", 512, 1, 5)
    cmp_progs = get("shamir_cmp").trace(512, num_workers=5)
    assert list(pf.iter_instrs()) == strip_frees(cmp_progs[1].instrs)


def test_workload_validation_and_rounds():
    with pytest.raises(ValueError, match="multiple"):
        get("shamir_stats").trace(1000, num_workers=3)
    with pytest.raises(ValueError, match="num_workers >= 3"):
        get("shamir_stats").trace(1024, num_workers=2)
    prog = get("shamir_stats").trace(1024, num_workers=3)[1]
    rounds = 1024 // 256 + 1             # the squares and mean^2
    assert sum(i.op == Op.NET_SEND for i in prog.instrs) == \
        rounds * 2 + 3                   # + the three reveal sends
    assert sum(i.op == Op.NET_RECV for i in prog.instrs) == rounds * 2


# ---------------------------------------------------------------------------
# jobs: three loops against the reference's run
# ---------------------------------------------------------------------------

JOBS = [("shamir_stats", 1024, 3), ("shamir_stats", 1024, 5),
        ("shamir_cmp", 512, 3), ("shamir_cmp", 512, 5)]


@functools.lru_cache(maxsize=None)
def _reference_job(wl: str, n: int, p: int):
    """The reference's plan at budget 0.5, run on its scalar loop: the
    outputs, each rank's final memory (uint64) and the messages and bytes
    of every worker link."""
    ref = RefSession(RefJobSpec(workload=wl, n=n, num_workers=p,
                                memory_budget=0.5))
    progs = ref.plan()
    fabric = ref_transport.InprocTransport(p)
    view = ref_transport.PartyView(fabric, 0, p)
    drivers = [ref_driver.ShamirDriver(p, k, ref.workload.inputs(n, k, p))
               for k in range(p)]
    engines = [RefEngine(progs[k], drivers[k], net=view) for k in range(p)]
    errors = []

    def run(e):
        try:
            e.run()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    out = {}
    for d in drivers:
        out.update(d.outputs)
    links = {k: (v.messages, v.bytes)
             for k, v in ref_transport.aggregate_links(fabric.stats()).items()}
    return out, [e.memory[:, 0].copy() for e in engines], links


@pytest.mark.parametrize("loop", ["scalar", "batched", "overlap"])
@pytest.mark.parametrize("wl,n,p", JOBS, ids=[f"{w}-{n}-p{p}"
                                              for w, n, p in JOBS])
def test_jobs_equal_reference(wl, n, p, loop):
    ref_out, ref_mem, ref_links = _reference_job(wl, n, p)
    with Session(JobSpec(wl, n=n, num_workers=p, memory_budget=0.5,
                         exec_backend=loop), device="cpu") as s:
        out = s.execute(check=True)
    assert s.driver_name == "shamir"
    assert sorted(out) == sorted(ref_out)
    for tag, want in ref_out.items():
        assert out[tag].dtype == np.uint64
        assert np.array_equal(out[tag], want), tag
    assert len(s.engines) == p
    for eng, want in zip(s.engines, ref_mem):
        assert np.array_equal(eng.memory[:, 0].numpy().view(np.uint64),
                              want)
    links = {k: (v.messages, v.bytes)
             for k, v in aggregate_links(s.transport_stats).items()}
    assert links == ref_links
    assert len(links) == p * (p - 1)
    if wl == "shamir_stats":
        assert sum(e.swap_ins + e.swap_outs for e in s.engine_stats) > 0
    if loop == "batched" and wl == "shamir_cmp":
        # the leaf differences batch; every other op of both workloads
        # is a chain link or sits between NET barriers
        assert sum(e.batched_instructions for e in s.engine_stats) >= p * 2
    if loop == "overlap":
        assert sum(e.posted_recvs for e in s.engine_stats) > 0


def test_cmp_reveals_exact_indicator():
    with Session(JobSpec("shamir_cmp", n=512, num_workers=3,
                         plan_mode="unbounded"), device="cpu") as s:
        (v,) = s.execute(check=True).values()
    assert v[:128].max() == 0 and v[128:].min() == 1


# ---------------------------------------------------------------------------
# drivers, registry, CLI, measured traffic
# ---------------------------------------------------------------------------


def test_driver_validates_parameters():
    with pytest.raises(ValueError, match="n >= 3"):
        ShamirDriver(2, 0, lambda tag: None)
    with pytest.raises(ValueError, match="out of range"):
        ShamirDriver(3, 3, lambda tag: None)
    with pytest.raises(ValueError, match="2t\\+1"):
        ShamirDriver(3, 0, lambda tag: None, threshold=2)
    d = ShamirDriver(5, 1, lambda tag: None)
    assert (d.threshold, d.lane, d.dtype) == (2, 1, torch.int64)
    ref = ref_driver.ShamirDriver(5, 1, lambda tag: None)
    assert d.seed_reshare == ref.seed_reshare
    for ins in get("shamir_stats").trace(1024, num_workers=3)[0].instrs:
        if ins.op != Op.FREE:
            assert d.cost(ins) == ref.cost(ins)


def test_fixed_party_drivers_and_auto():
    spec = JobSpec("shamir_stats", n=1024, num_workers=3,
                   plan_mode="unbounded", driver="shamir-5party")
    with pytest.raises(ValueError, match="num_workers=5"):
        with Session(spec, device="cpu") as s:
            s.execute()
    ok = JobSpec("shamir_stats", n=1024, num_workers=3,
                 plan_mode="unbounded", driver="shamir-3party")
    with Session(ok, device="cpu") as s:
        assert len(s.execute(check=True)) == 3
    auto = JobSpec("shamir_cmp", n=512, num_workers=3, plan_mode="unbounded")
    assert auto.normalized().driver == "shamir"
    assert auto.plan_hash() == RefJobSpec(
        workload="shamir_cmp", n=512, num_workers=3,
        plan_mode="unbounded").plan_hash()


def test_cli_exec_plan_and_run(tmp_path, capsys):
    assert cli.main(["exec", "--workload", "shamir_stats", "-n", "1024",
                     "--workers", "3", "--budget", "0.5", "--check",
                     "--exec-backend", "overlap", "--device", "cpu"]) == 0
    assert '"driver": "shamir"' in capsys.readouterr().out
    job = tmp_path / "job"
    assert cli.main(["plan", "--workload", "shamir_stats", "-n", "1024",
                     "--workers", "3", "--budget", "0.5", "--out", str(job),
                     "--device", "cpu"]) == 0
    assert cli.main(["run", str(job), "--driver", "shamir-3party", "--check",
                     "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["run", str(job), "--driver", "shamir-5party", "--check",
                  "--device", "cpu"])
    assert "oracle check OK" in capsys.readouterr().out


def test_fleet_outputs_load_as_uint64(tmp_path):
    path = tmp_path / "rank.json"
    want = {sw.OUT_TAGS: np.array([0, 1, P - 1], dtype=np.uint64)}
    cli._dump(str(path), want)
    outs, _ = cli._load(str(path), "shamir")
    assert outs[sw.OUT_TAGS].dtype == np.uint64
    assert np.array_equal(outs[sw.OUT_TAGS], want[sw.OUT_TAGS])


def test_measure_traffic_over_shaped_links():
    """fig_nparty's measured section at a test size: scalar against
    overlap over shaped links, identical outputs and total bytes."""
    fab = FabricSpec(latency_s=0.002, bandwidth=250e6)
    kw = dict(num_workers=3, transport="shaped", fabric=fab, check=True,
              device="cpu")
    ino = sc.measure_traffic("shamir_stats", 1024, exec_backend="scalar",
                             **kw)
    ovl = sc.measure_traffic("shamir_stats", 1024, exec_backend="overlap",
                             **kw)
    assert sorted(ino.outputs) == sorted(ovl.outputs)
    assert all(np.array_equal(ino.outputs[k], ovl.outputs[k])
               for k in ino.outputs)
    assert ino.total_bytes == ovl.total_bytes > 0
    assert len(ino.links) == 6
