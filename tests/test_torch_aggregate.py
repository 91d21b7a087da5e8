"""The port's secure aggregation against the JAX package's on the CPU
(``run_aggregation(device="cpu")``).

* The offline phase: ``client_vector``, ``client_shares``,
  ``expected_sum`` and ``build_round_plan`` equal the reference's bit for
  bit, ``AggSpec.plan_key`` over a grid of specs, and a round plan cached
  by either package is a hit in the other.
* The online phase: the aggregates, survivors and per-link totals equal
  the reference's: several rounds, one server and one gateway, stragglers
  (``--drop``), and a word-wrapping round (every client's vector near
  2**64); backpressure keeps every gateway link's reorder peak at or under
  the knob plus the largest message that link carries; admission
  reserves each round; hot rounds make zero re-plans; shaped WAN links
  report latency percentiles.
* The CLI: ``agg --check --json`` and ``--drop``, refusals, and two
  processes over TCP (``python -m repro_torch agg --rank K``) equal to
  the in-process run (aggregates, survivors and link bytes).
* Without a card, ``run_aggregation`` without ``device="cpu"`` raises.
* The transports: ``set_depth(max_bytes=)`` and ``reorder_stats`` on the
  inproc, tcp and shaped backends.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro.aggregate as ref_agg
import repro.aggregate.offline as ref_offline
from repro.serve_daemon.cache import ArtifactCache as RefCache
from repro_torch import __main__ as cli
from repro_torch.aggregate import (AggSpec, build_round_plan, client_shares,
                                   client_vector, expected_sum,
                                   largest_message, load_round_plan,
                                   run_aggregation, verify_aggregates)
from repro_torch.aggregate import offline
from repro_torch.core.transport import FabricSpec, pick_free_ports
from repro_torch.serve_daemon import ArtifactCache

REPO = pathlib.Path(__file__).resolve().parents[1]

SPECS = [dict(clients=5, vec_len=32, servers=3),
         dict(clients=40, vec_len=16, rounds=3, gateways=3),
         dict(clients=9, vec_len=4, servers=1, gateways=1, seed=11),
         dict(clients=2000, vec_len=64, rounds=3, max_inflight_bytes=1)]


def _ids(d):
    return "-".join(f"{k}{v}" for k, v in d.items())


@pytest.mark.parametrize("kw", SPECS, ids=_ids)
def test_offline_phase_is_the_references(kw):
    spec, ref = AggSpec(**kw), ref_agg.AggSpec(**kw)
    assert spec.plan_key() == ref.plan_key()
    assert build_round_plan(spec).to_dict() == \
        ref_agg.build_round_plan(ref).to_dict()
    for rnd in range(spec.rounds):
        for c in range(min(spec.clients, 6)):
            assert np.array_equal(client_vector(spec.seed, c, rnd,
                                                spec.vec_len),
                                  ref_agg.client_vector(ref.seed, c, rnd,
                                                        ref.vec_len))
            for a, b in zip(client_shares(spec, c, rnd),
                            ref_agg.client_shares(ref, c, rnd)):
                assert a.dtype == b.dtype == np.uint64
                assert np.array_equal(a, b)
        if spec.clients <= 40:
            assert np.array_equal(expected_sum(spec, rnd),
                                  ref_agg.expected_sum(ref, rnd))
    for name in ("data_tag",):
        assert getattr(offline, name)(spec, 1, 3) == \
            getattr(ref_offline, name)(ref, 1, 3)
    for name in ("manifest_tag", "survivor_tag", "partial_tag"):
        assert getattr(offline, name)(2) == getattr(ref_offline, name)(2)


def test_plan_key_ignores_online_knobs_and_bad_specs():
    a = AggSpec(clients=10, round_timeout_s=5.0, max_inflight_bytes=1)
    b = AggSpec(clients=10, round_timeout_s=99.0, max_inflight_bytes=2)
    assert a.plan_key() == b.plan_key() != AggSpec(clients=11).plan_key()
    for bad in (dict(clients=0), dict(clients=4, servers=0),
                dict(clients=4, rounds=0)):
        with pytest.raises(ValueError):
            AggSpec(**bad)


def test_round_plans_cached_across_packages(tmp_path):
    spec = AggSpec(clients=12, gateways=3)
    ref = ref_agg.AggSpec(clients=12, gateways=3)
    plan, ev = load_round_plan(ArtifactCache(tmp_path / "a"), spec)
    assert ev == "miss"
    again, ev = ref_agg.load_round_plan(RefCache(tmp_path / "a"), ref)
    assert ev == "hit" and again.to_dict() == plan.to_dict()
    ref_agg.load_round_plan(RefCache(tmp_path / "b"), ref)
    cache = ArtifactCache(tmp_path / "b")
    got, ev = load_round_plan(cache, spec)
    assert ev == "hit" and got.to_dict() == plan.to_dict()
    assert cache.stats.agg_hits == 1 and cache.stats.invalid == 0
    assert load_round_plan(None, spec)[1] == "none"


def _links(res) -> dict:
    return {k: (v.messages, v.bytes) for k, v in res.link_totals.items()}


RUNS = [dict(kw=dict(clients=40, vec_len=16, rounds=3, gateways=3)),
        dict(kw=dict(clients=9, vec_len=4, servers=1, gateways=1)),
        dict(kw=dict(clients=20, vec_len=8, rounds=2),
             drop=[(0, 3), (0, 17), (1, 0)]),
        dict(kw=dict(clients=25, vec_len=8, servers=3, seed=3),
             drop=[(0, c) for c in range(0, 25, 2)])]


@pytest.mark.parametrize("run", RUNS, ids=lambda r: _ids(r["kw"]) + (
    "-drop" if "drop" in r else ""))
def test_aggregation_is_the_references(run):
    spec = AggSpec(**run["kw"])
    res = run_aggregation(spec, drop=run.get("drop"), device="cpu")
    ref = ref_agg.run_aggregation(ref_agg.AggSpec(**run["kw"]),
                                  drop=run.get("drop"))
    verify_aggregates(res)
    assert len(res.rounds) == spec.rounds
    for a, b in zip(res.rounds, ref.rounds):
        assert a.total.dtype == np.uint64
        assert np.array_equal(a.total, b.total)
        assert a.survivors == b.survivors and a.degraded == b.degraded
    assert _links(res) == _links(ref)
    assert res.device == "cpu" and res.clients_per_s > 0
    assert res.latency_ms.keys() == {"p50", "p90", "p99"}


def test_sum_wraps_as_uint64(monkeypatch):
    """Every word near 2**64: the int64 sum wraps to the uint64 sum."""
    def near_top(seed, client, rnd, vec_len):
        rng = np.random.default_rng((seed, 9, rnd, client))
        return np.uint64(2**64 - 1) - rng.integers(0, 1 << 8, vec_len,
                                                   dtype=np.uint64)
    monkeypatch.setattr(offline, "client_vector", near_top)
    spec = AggSpec(clients=50, vec_len=8, rounds=2)
    res = run_aggregation(spec, device="cpu")
    verify_aggregates(res)
    total = res.rounds[0].total
    want = sum(near_top(spec.seed, c, 0, 8).astype(object)
               for c in range(50)) % (1 << 64)
    assert [int(v) for v in total] == [int(v) for v in want]


def test_backpressure_peaks_under_knob_plus_largest_message():
    """A send waits only while its link is at the bound, so a peak may
    pass the knob by one message; the largest on a gateway link is its
    manifest (8 B a client) or a share."""
    spec = AggSpec(clients=150, vec_len=32, max_inflight_bytes=512)
    res = run_aggregation(spec, device="cpu")
    verify_aggregates(res)
    plan = build_round_plan(spec)
    checked = 0
    for (src, dst), st in res.reorder.items():
        if dst < spec.servers and src >= spec.servers:
            g = src - spec.servers
            big = largest_message(spec, plan, g)
            assert big == 8 * 75 > plan.share_bytes
            assert st.max_bytes == 512
            assert st.peak_bytes <= 512 + big, (src, dst, st)
            assert st.pending_bytes == 0
            checked += 1
    assert checked == spec.gateways * spec.servers


def test_admission_reserves_each_round():
    spec = AggSpec(clients=30, vec_len=16, rounds=2)
    adm = run_aggregation(spec, device="cpu").admission
    assert adm["admitted"] == spec.servers * spec.rounds
    assert adm["peak_frames"] >= build_round_plan(spec).frames
    assert adm["active"] == 0 and adm["frames_in_use"] == 0


def test_hot_rounds_make_no_replan(tmp_path):
    spec = AggSpec(clients=25, vec_len=8, rounds=3)
    cold = ArtifactCache(tmp_path)
    res = run_aggregation(spec, cache=cold, device="cpu")
    assert res.plan_events == ["miss", "hit", "hit"]
    assert cold.stats.agg_misses == 1 and cold.stats.agg_hits == 2
    hot = ArtifactCache(tmp_path)
    res2 = run_aggregation(spec, cache=hot, device="cpu")
    assert res2.plan_events == ["hit"] * 3
    assert hot.stats.agg_misses == 0
    for a, b in zip(res.rounds, res2.rounds):
        assert np.array_equal(a.total, b.total)


def test_shaped_wan_reports_latency_percentiles():
    spec = AggSpec(clients=20, vec_len=8)
    res = run_aggregation(spec, transport="shaped",
                          fabric_spec=FabricSpec(latency_s=0.005,
                                                 bandwidth=1e9),
                          device="cpu")
    verify_aggregates(res)
    assert res.latency_ms["p50"] >= 5.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_without_a_card_it_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_aggregation(AggSpec(clients=4))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_check_json_and_drop(tmp_path, capsys):
    out = tmp_path / "agg.json"
    assert cli.main(["agg", "--clients", "10", "--rounds", "2", "--vec-len",
                     "4", "--drop", "1:2,5", "--check", "--json", str(out),
                     "--device", "cpu"]) == 0
    assert "DEGRADED (2 dropped)" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["schema_version"] >= 1 and doc["device"] == "cpu"
    assert doc["rounds"][0]["survivors"] == list(range(10))
    assert doc["rounds"][1]["degraded"] is True
    assert 2 not in doc["rounds"][1]["survivors"]
    assert doc["admission"]["active"] == 0
    assert any(k in doc["reorder"] for k in ("2->0", "3->0"))


def test_cli_refusals():
    with pytest.raises(SystemExit, match="--drop"):
        cli.main(["agg", "--clients", "4", "--drop", "nope"])
    with pytest.raises(SystemExit, match="--peers"):
        cli.main(["agg", "--clients", "4", "--rank", "0"])


def test_two_processes_over_tcp_equal_in_process(tmp_path):
    args = ["--clients", "30", "--rounds", "2", "--vec-len", "8",
            "--servers", "1", "--gateways", "1", "--device", "cpu"]
    single = tmp_path / "single.json"
    assert cli.main(["agg", *args, "--check", "--json", str(single)]) == 0
    peers = ",".join(f"127.0.0.1:{p}" for p in pick_free_ports(2))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    outs = [tmp_path / f"rank{k}.json" for k in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "agg", *args, "--peers", peers,
         "--rank", str(k), "--json", str(outs[k])]
        + (["--check"] if k == 0 else []), env=env) for k in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    a = json.loads(single.read_text())
    docs = [json.loads(o.read_text()) for o in outs]
    assert [r["aggregate"] for r in a["rounds"]] == \
        [r["aggregate"] for r in docs[0]["rounds"]]
    assert [r["survivors"] for r in a["rounds"]] == \
        [r["survivors"] for r in docs[0]["rounds"]]
    assert docs[1]["rounds"] == [] and docs[0]["transport"] == "tcp"
    links = {**docs[0]["link_totals"], **docs[1]["link_totals"]}
    assert links == a["link_totals"]


@pytest.mark.parametrize("backend", ["inproc", "tcp", "shaped"])
def test_depth_bounds_and_reorder_peaks(backend):
    """``set_depth(max_bytes=)`` bounds a link's pending bytes on every
    backend and one more message always passes (the peak is the bound
    plus that message); ``max_bytes=None`` keeps the byte bound the link
    had (TCP's ``max_link_bytes``), as the garbled stream's depth calls
    rely on."""
    from repro_torch.core.transport import build_fabric
    peers = tuple(f"127.0.0.1:{p}" for p in pick_free_ports(2)) \
        if backend == "tcp" else ()
    fx = build_fabric(backend, 2, FabricSpec(peers=peers))
    fx.connect()
    try:
        t0, t1 = fx.transport_for(0), fx.transport_for(1)
        t1.set_depth(0, 1, max_msgs=4)
        before = fx.reorder_stats()[(0, 1)].max_bytes
        assert before == (64 << 20 if backend == "tcp" else 0)
        t1.set_depth(0, 1, max_msgs=0, max_bytes=100)
        msg = torch.arange(8, dtype=torch.int64)          # 64 B
        for k in range(2):
            t0.send(0, 1, 5, msg + k)
        deadline = time.monotonic() + 30     # a TCP reader puts them
        while fx.reorder_stats()[(0, 1)].pending_msgs < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        got = [t1.recv(0, 1, 5, timeout=30) for _ in range(2)]
        st = fx.reorder_stats()[(0, 1)]
        assert [int(g[0]) for g in got] == [0, 1]
        assert (st.max_msgs, st.max_bytes, st.pending_bytes) == (0, 100, 0)
        assert st.peak_msgs == 2 and st.peak_bytes == 128 <= 100 + 64
    finally:
        fx.close()
