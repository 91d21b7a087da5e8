"""The port's artifact cache and the cache hooks of its Session against
the JAX package on the CPU.

* ``JobSpec.trace_hash`` and ``plan_hash`` equal the reference's over a
  grid of specs (GC, CKKS and Shamir; one and four workers; float and
  integer budgets; all three plan modes).
* Cache hits: cold and hot plan digests are equal, a hot Session makes no
  trace and no plan and keeps its configs and reports; a hot execute
  equals the cold one (outputs, AND count and table digest) on the
  batched and the overlap loop, its schedules from the cache; the trace
  entry is shared across budgets; ``trace(cache_dir=)`` alone caches.
* Tampering: a changed program file is rejected and planned again, an
  edited manifest spec is rejected, LRU eviction keeps the cap.
* Across packages: a cache root written by the reference's
  ``Session(cache=)`` hits in the port with the same plan digests, one
  written by the port hits in the reference; batch and overlap schedule
  files load in either package and compare equal.
* ``estimate_job_resources`` equals the reference's; ``save_plan`` of a
  cache-resident plan copies it; ``scenarios`` with ``cache_dir`` gives
  the reference's rows.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from repro.api import (JobSpec as RefJobSpec, Session as RefSession,
                       estimate_job_resources as ref_estimate)
from repro.exec.batching import (BatchSchedule as RefBatch,
                                 build_batch_schedule as ref_build_batch)
from repro.exec.overlap import (OverlapSchedule as RefOverlap,
                                build_overlap_schedule as ref_build_overlap)
from repro.scenarios import run_workload as ref_run_workload
from repro.serve_daemon.cache import ArtifactCache as RefCache
from repro.serve_daemon.server import program_digest as ref_digest
from repro_torch.api import JobSpec, Session, estimate_job_resources
from repro_torch.core.bytecode import ProgramFile
from repro_torch.exec.batching import BatchSchedule, build_batch_schedule
from repro_torch.exec.overlap import OverlapSchedule, build_overlap_schedule
from repro_torch.scenarios import run_workload
from repro_torch.serve_daemon import ArtifactCache, program_digest

from _torch_gc_jobs import same_outputs

#: a small streaming GC job, as the reference's serve tests plan it
SPEC = dict(workload="merge", n=256, memory_budget=12, plan_mode="streaming")

HASH_SPECS = [
    dict(workload="merge", n=64, memory_budget=10),
    dict(workload="merge", n=256, num_workers=4, memory_budget=0.4,
         prefetch_pages=16, plan_mode="streaming"),
    dict(workload="sort", n=128, plan_mode="unbounded"),
    dict(workload="rsum", n=32, num_workers=4, memory_budget=3,
         ckks_ring=128, plan_mode="streaming"),
    dict(workload="rmvmul", n=24, memory_budget=0.4, ckks_ring=1024,
         ckks_levels=2),
    dict(workload="pir", plan_mode="unbounded"),
    dict(workload="shamir_stats", n=1024, num_workers=3, memory_budget=0.5),
    dict(workload="shamir_cmp", n=64, num_workers=5, memory_budget=7,
         plan_mode="streaming", policy="lru"),
    dict(workload="aggsum", n=16, memory_budget=4),
]


def _digests(progs) -> list[str]:
    return [program_digest(p) for p in progs]


@pytest.mark.parametrize("spec", HASH_SPECS, ids=lambda d: "-".join(
    f"{v}" for v in d.values()))
def test_trace_and_plan_hash_are_the_references(spec):
    ours, ref = JobSpec(**spec), RefJobSpec(**spec)
    assert ours.trace_hash() == ref.trace_hash()
    assert ours.plan_hash() == ref.plan_hash()
    # the trace hash leaves the plan knobs out, the plan hash the loop
    if "memory_budget" in spec:
        other = dataclasses.replace(ours, lookahead=7, prefetch_pages=1)
        assert other.trace_hash() == ours.trace_hash()
        assert other.plan_hash() != ours.plan_hash()
    assert dataclasses.replace(ours, exec_backend="scalar").plan_hash() == \
        ours.plan_hash()


@pytest.mark.parametrize("mode", ["memory", "streaming"])
def test_cache_hit_identical_digests(tmp_path, mode):
    spec = JobSpec(**dict(SPEC, plan_mode=mode))
    cache = ArtifactCache(tmp_path / "cache")
    with Session(spec, device="cpu", cache=cache) as s:
        cold = _digests(s.plan())
        assert s.cache_events == {"trace": "miss", "plan": "miss"}
        cold_cfgs, cold_reports = s.configs, s.plan_reports
    with Session(spec, device="cpu", cache=cache) as s:
        hot = _digests(s.plan())
        assert s.cache_events == {"plan": "hit"}     # no trace at all
        assert s._progs is None
        assert s.configs == cold_cfgs
        assert s.plan_reports[0].replacement == cold_reports[0].replacement
        assert all(isinstance(p, ProgramFile) for p in s.plan())
    assert hot == cold
    assert cache.stats.plan_hits == 1 and cache.stats.invalid == 0
    # the plan without a cache is the same program
    with Session(spec, device="cpu") as s:
        assert _digests(s.plan()) == cold


@pytest.mark.parametrize("backend", ["batched", "overlap"])
def test_hot_execute_equals_cold(tmp_path, backend):
    """Two-party aggsum at a swapping budget: the hot run's outputs, AND
    count and table digest equal the cold run's, its plan and schedules
    come from the cache."""
    spec = JobSpec("aggsum", n=6, memory_budget=4, exec_backend=backend)
    kind = {"batched": "batch", "overlap": "overlap"}[backend]
    runs = []
    for _ in range(2):
        with Session(spec, device="cpu", cache=tmp_path / "c") as s:
            out = s.execute(real=True, check=True, digest=True)
            runs.append((out, s.gate_counts[0].ands, s.table_digest,
                         dict(s.cache_events)))
    (cold, ands, dig, ev0), (hot, ands1, dig1, ev1) = runs
    assert ev0 == {"trace": "miss", "plan": "miss", kind: "miss"}
    assert ev1 == {"plan": "hit", kind: "hit"}
    assert same_outputs(hot, cold) and ands1 == ands > 0 and dig1 == dig


def test_trace_cache_shared_across_budgets(tmp_path):
    cache = ArtifactCache(tmp_path / "cache")
    with Session(JobSpec(**SPEC), device="cpu", cache=cache) as s:
        s.plan()
    other = JobSpec(**dict(SPEC, memory_budget=8))
    assert other.trace_hash() == JobSpec(**SPEC).trace_hash()
    with Session(other, device="cpu", cache=cache) as s:
        got = _digests(s.plan())
        assert s.cache_events == {"trace": "hit", "plan": "miss"}
        # the cached sidecar is reused: no annotation pass ran
        assert s.plan_reports[0].annotate_s == 0.0
    assert cache.stats.trace_hits == 1
    with Session(other, device="cpu") as s:
        assert _digests(s.plan()) == got


def test_trace_cache_dir_standalone(tmp_path):
    with Session(JobSpec(**SPEC), device="cpu") as s:
        n_instrs = len(s.trace(cache_dir=tmp_path / "c")[0])
    with Session(JobSpec(**SPEC), device="cpu") as s:
        progs = s.trace(cache_dir=tmp_path / "c")
        assert s.cache_events == {"trace": "hit"}
        assert len(progs[0]) == n_instrs
        # a cached file is restamped with THIS spec's identity in memory
        assert progs[0].meta["spec_hash"] == JobSpec(**SPEC).plan_hash()


def test_tampered_plan_rejected_and_replanned(tmp_path):
    spec = JobSpec(**SPEC)
    cache = ArtifactCache(tmp_path / "cache")
    with Session(spec, device="cpu", cache=cache) as s:
        cold = _digests(s.plan())
    victim = os.path.join(cache.root, "plan", spec.plan_hash(),
                          "worker0.memory.bc")
    with open(victim, "r+b") as f:       # flip bytes mid-file
        f.seek(os.path.getsize(victim) // 2)
        f.write(b"\xff\xff\xff\xff")
    with Session(spec, device="cpu", cache=cache) as s:
        assert _digests(s.plan()) == cold             # planned again
        assert s.cache_events["plan"] == "miss"
    assert cache.stats.invalid == 1
    assert program_digest(ProgramFile(victim)) == cold[0]
    with Session(spec, device="cpu", cache=cache) as s:
        s.plan()
        assert s.cache_events["plan"] == "hit"


def test_tampered_manifest_spec_rejected(tmp_path):
    spec = JobSpec(**SPEC)
    cache = ArtifactCache(tmp_path / "cache")
    with Session(spec, device="cpu", cache=cache) as s:
        s.plan()
    man = os.path.join(cache.root, "plan", spec.plan_hash(), "manifest.json")
    with open(man) as f:
        doc = json.load(f)
    doc["spec"]["n"] = 4096
    with open(man, "w") as f:
        json.dump(doc, f)
    assert cache.get_plan(spec) is None
    assert cache.stats.invalid == 1
    assert not os.path.exists(man)                    # the entry is gone


def test_lru_eviction_respects_cap(tmp_path):
    cache = ArtifactCache(tmp_path / "cache")
    specs = [JobSpec("merge", n=n, memory_budget=16, plan_mode="streaming")
             for n in (128, 256, 512)]
    for spec in specs:
        with Session(spec, device="cpu", cache=cache) as s:
            s.plan()
    assert cache.entry_count() == 6          # 3 traces + 3 plans
    cache.max_bytes = cache.total_bytes() // 2
    time.sleep(0.02)
    assert cache.get_plan(specs[-1]) is not None      # the newest, touched
    with Session(JobSpec("rsum", n=32, memory_budget=8, ckks_ring=128,
                         plan_mode="streaming"), device="cpu",
                 cache=cache) as s:
        s.plan()                             # the put evicts
    assert cache.total_bytes() <= cache.max_bytes
    assert cache.stats.evictions > 0
    assert cache.get_plan(specs[-1]) is not None
    assert cache.get_plan(specs[0]) is None


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["memory", "streaming"])
def test_reference_cache_root_hits_in_the_port(tmp_path, mode):
    spec = dict(SPEC, plan_mode=mode)
    root = tmp_path / "cache"
    with RefSession(RefJobSpec(**spec), cache=root) as r:
        want = [ref_digest(p) for p in r.plan()]
        want_cfgs = [dataclasses.asdict(c) for c in r._cfgs]
    with Session(JobSpec(**spec), device="cpu", cache=root) as s:
        assert _digests(s.plan()) == want
        assert s.cache_events == {"plan": "hit"}
        assert [dataclasses.asdict(c) for c in s.configs] == want_cfgs
        out = s.execute(real=False, check=True)
    # the reference's trace entry serves the port another budget, and the
    # port's plan of it is the reference's
    other = dict(spec, memory_budget=8)
    with Session(JobSpec(**other), device="cpu", cache=root) as s:
        got = _digests(s.plan())
        assert s.cache_events == {"trace": "hit", "plan": "miss"}
    with RefSession(RefJobSpec(**other)) as r:
        assert [ref_digest(p) for p in r.plan()] == got
        assert same_outputs(out, RefSession(RefJobSpec(**spec)).execute())


def test_port_cache_root_hits_in_the_reference(tmp_path):
    root = tmp_path / "cache"
    spec = dict(SPEC, exec_backend="batched")
    with Session(JobSpec(**spec), device="cpu", cache=root) as s:
        want = _digests(s.plan())
        s.execute(real=False)                 # a batch entry too
    with RefSession(RefJobSpec(**spec), cache=root) as r:
        assert [ref_digest(p) for p in r.plan()] == want
        assert r.cache_events == {"plan": "hit"}
        r.execute(check=True)
        assert r.cache_events["batch"] == "hit"
    other = dict(spec, memory_budget=8)
    with RefSession(RefJobSpec(**other), cache=root) as r:
        r.plan()
        assert r.cache_events == {"trace": "hit", "plan": "miss"}
    assert RefCache(root).stats.invalid == 0


def _same_schedule(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype == np.int64
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", ["batch", "overlap"])
def test_schedule_files_load_across_packages(tmp_path, kind):
    spec = dict(workload="merge", n=64, num_workers=2, memory_budget=6,
                prefetch_pages=1)
    port = Session(JobSpec(**spec), device="cpu").plan()[1]
    ref = RefSession(RefJobSpec(**spec)).plan()[1]
    build, ref_build, cls, ref_cls = {
        "batch": (build_batch_schedule, ref_build_batch, BatchSchedule,
                  RefBatch),
        "overlap": (build_overlap_schedule, ref_build_overlap,
                    OverlapSchedule, RefOverlap)}[kind]
    ours, theirs = build(port), ref_build(ref)
    ours.save(tmp_path / "port.npz")
    theirs.save(tmp_path / "ref.npz")
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "ref.npz").read_bytes()
    _same_schedule(ref_cls.load(tmp_path / "port.npz"), theirs)
    loaded = cls.load(tmp_path / "ref.npz")
    _same_schedule(loaded, ours)
    loaded.validate_for(port)
    with pytest.raises(ValueError, match="stale"):
        loaded.validate_for(Session(JobSpec(**dict(spec, n=32)),
                                    device="cpu").plan()[1])


ESTIMATE_SPECS = [
    dict(workload="merge", n=256, memory_budget=24, plan_mode="streaming"),
    dict(workload="merge", n=256, num_workers=2, memory_budget=0.4,
         prefetch_pages=4),
    dict(workload="merge", n=64, plan_mode="unbounded", driver="gc-2party"),
    dict(workload="rsum", n=32, memory_budget=0.5, ckks_ring=128),
    dict(workload="shamir_stats", n=256, num_workers=3, memory_budget=6),
]


@pytest.mark.parametrize("spec", ESTIMATE_SPECS, ids=lambda d: "-".join(
    f"{v}" for v in d.values()))
def test_estimate_job_resources_is_the_references(spec, tmp_path):
    with Session(JobSpec(**spec), device="cpu") as s:
        got = estimate_job_resources(s)
        if isinstance(spec.get("memory_budget"), int):
            assert s._progs is None          # sized without a trace
    assert got == ref_estimate(RefSession(RefJobSpec(**spec)))
    if spec.get("plan_mode") != "unbounded":
        # from a cached plan: its configs, no trace, no planner bytes
        with Session(JobSpec(**spec), device="cpu", cache=tmp_path) as s:
            s.plan()
        with Session(JobSpec(**spec), device="cpu", cache=tmp_path) as s:
            hot = estimate_job_resources(s)
            assert s._progs is None and s.cache_events == {"plan": "hit"}
        with RefSession(RefJobSpec(**spec), cache=tmp_path) as r:
            assert hot == ref_estimate(r)
        assert hot[0] == got[0]


def test_save_plan_of_a_cached_plan_copies_it(tmp_path):
    spec = JobSpec(**SPEC)
    with Session(spec, device="cpu", cache=tmp_path / "c") as s:
        want = _digests(s.plan())
    for mode in ("streaming", "unbounded"):
        job = dataclasses.replace(spec, plan_mode=mode,
                                  memory_budget=None if mode == "unbounded"
                                  else spec.memory_budget)
        with Session(job, device="cpu", cache=tmp_path / "c") as s:
            s.save_plan(tmp_path / mode)
        loaded = Session.from_plan(tmp_path / mode, device="cpu")
        if mode == "streaming":
            assert _digests(loaded.plan()) == want
        loaded.execute(real=False, check=True)
    # the cache's files stayed where they were, and still hit
    with Session(spec, device="cpu", cache=tmp_path / "c") as s:
        s.plan()
        assert s.cache_events == {"plan": "hit"}
    assert ArtifactCache(tmp_path / "c").stats.invalid == 0


def test_scenarios_through_the_cache_are_the_references(tmp_path):
    """``run_workload(cache_dir=)`` cold and hot gives the reference's row
    through its own cache (model seconds, swaps, instructions of the
    cached, FREE-stripped trace); the hot run plans nothing."""
    want = ref_run_workload("merge", 256, budget_frac=0.4, sim_core="scalar",
                            cache_dir=tmp_path / "ref")
    keys = ("unbounded_s", "os_s", "mage_s", "swaps_in", "swaps_out",
            "prefetched", "working_set_pages", "budget_pages",
            "instructions", "os_read_bytes", "mage_write_bytes")
    for _ in range(2):
        got = run_workload("merge", 256, budget_frac=0.4, device="cpu",
                           cache_dir=tmp_path / "port")
        assert {k: getattr(got, k) for k in keys} == \
            {k: getattr(want, k) for k in keys}
    assert ArtifactCache(tmp_path / "port").entry_count() == 2


def test_cli_cache_flags(tmp_path, capsys):
    """``--cache`` on ``plan``, ``exec`` and ``bench``: the second run of a
    shape hits, and gives what the first gave."""
    from repro_torch import __main__ as cli
    cache = str(tmp_path / "c")
    plan = ["plan", "--workload", "merge", "-n", "256", "--budget", "12",
            "--cache", cache, "--device", "cpu"]
    assert cli.main(plan + ["--out", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert "'trace': 'miss'" in out and "'plan': 'miss'" in out
    assert cli.main(plan + ["--out", str(tmp_path / "b")]) == 0
    assert "cache: {'plan': 'hit'}" in capsys.readouterr().out
    assert _digests(Session.from_plan(tmp_path / "b", device="cpu").plan()) \
        == _digests(Session.from_plan(tmp_path / "a", device="cpu").plan())
    summary = tmp_path / "exec.json"
    assert cli.main(["exec", "--workload", "merge", "-n", "256", "--budget",
                     "12", "--mode", "streaming", "--check", "--cache",
                     cache, "--device", "cpu", "--json", str(summary)]) == 0
    assert json.loads(summary.read_text())["cache"] == {"plan": "hit",
                                                        "batch": "miss"}
    rows = []
    for k in range(2):
        out = tmp_path / f"bench{k}.json"
        assert cli.main(["bench", "--cases", "rsum=32", "--no-check",
                         "--cache", cache, "--device", "cpu", "--json",
                         str(out)]) == 0
        rows.append(json.loads(out.read_text())["rows"])
    keys = ("unbounded_s", "os_s", "mage_s", "swaps_in", "instructions")
    assert [{k: r[k] for k in keys} for r in rows[0]] == \
        [{k: r[k] for k in keys} for r in rows[1]]
    st = ArtifactCache(cache).status()
    assert st["entries"] == 5 and st["invalid"] == 0   # 2 traces, 2 plans,
    #                                                    1 batch schedule
