"""The port's fleet on the CPU: one process a rank over localhost TCP, as
the JAX package's ``tests/test_transport.py`` runs its own.

* Two ``run JOBDIR --worker K --peers ...`` processes of a merge at two
  workers give the single-process ``run JOBDIR``'s outputs, bit for bit.
* ``fabric JOBDIR --real --check --digest`` runs a two-party merge at two
  workers as four processes: the merged outputs pass the oracle, each
  rank reports the device it ran on, and the AND counts and each garbler
  rank's table digest equal the same plan run in one process.
* Refusals: a distributed rank refuses ``check=True``, ``run --worker``
  needs ``--peers`` and refuses ``--check``, and a fleet that outlasts its
  ``--timeout`` is killed and fails.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.transport import FabricSpec, pick_free_ports

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PLAN = ["plan", "--workload", "merge", "-n", "64", "--workers", "2",
        "--budget", "10", "--lookahead", "40", "--prefetch", "2",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fleet") / "job")
    assert cli.main(PLAN + ["--out", out]) == 0
    return out


def test_two_process_run_matches_single_process(job, tmp_path):
    single = tmp_path / "single.json"
    assert cli.main(["run", job, "--check", "--json", str(single),
                     "--device", "cpu"]) == 0
    env = {**os.environ, "PYTHONPATH": SRC}
    peers = ",".join(f"127.0.0.1:{p}" for p in pick_free_ports(2))
    procs = []
    for rank in range(2):
        out = tmp_path / f"rank{rank}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "run", job, "--worker",
             str(rank), "--peers", peers, "--json", str(out), "--device",
             "cpu"], env=env, cwd=str(tmp_path))))
    try:
        for _, proc in procs:
            assert proc.wait(timeout=120) == 0
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
    merged = {}
    for out, _ in procs:
        doc = json.loads(out.read_text())
        assert doc["report"]["device"] == "cpu"
        merged.update(doc["outputs"])
    want = json.loads(single.read_text())
    assert merged == want["outputs"] and len(merged) == 4
    assert want["report"]["hosted"] == [0, 1]


def test_cli_fabric_two_party_fleet(tmp_path, capsys):
    job = str(tmp_path / "job")
    assert cli.main(["plan", "--workload", "merge", "-n", "32", "--workers",
                     "2", "--budget", "6", "--prefetch", "1", "--device",
                     "cpu", "--out", job]) == 0
    merged = tmp_path / "fleet.json"
    assert cli.main(["fabric", job, "--real", "--check", "--digest",
                     "--json", str(merged), "--device", "cpu",
                     "--timeout", "240"]) == 0
    assert "oracle check OK" in capsys.readouterr().out
    doc = json.loads(merged.read_text())
    ranks = {r["rank"]: r for r in doc["ranks"]}
    assert sorted(ranks) == [0, 1, 2, 3] and doc["driver"] == "gc-2party"
    assert all(r["device"] == "cpu" and r["hosted"] == [k]
               for k, r in ranks.items())
    s = Session.from_plan(job, device="cpu")
    out = s.execute(real=True, check=True, digest=True)
    assert sorted(doc["outputs"]) == sorted(str(k) for k in out)
    for k in range(2):          # garbler k -> evaluator 2 + k
        assert ranks[k]["and_gates"][0] == ranks[2 + k]["and_gates"][1] > 0
        assert ranks[k]["table_digests"] == \
            {f"{k}->{2 + k}": s.table_digests[(k, 2 + k)]}
    assert sum(ranks[k]["and_gates"][0] for k in range(2)) == \
        s.gate_counts[0].ands


def test_distributed_rank_refuses_check():
    spec = JobSpec("merge", n=64, num_workers=2, memory_budget=10,
                   prefetch_pages=2, transport="tcp",
                   fabric=FabricSpec(rank=0, peers=("h:1", "h:2")))
    with pytest.raises(ValueError, match="full outputs"):
        Session(spec, device="cpu").execute(real=False, check=True)


def test_cli_refusals(job):
    with pytest.raises(SystemExit, match="--peers"):
        cli.main(["run", job, "--worker", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="full outputs"):
        cli.main(["run", job, "--worker", "0", "--peers", "a:1,b:2",
                  "--check", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--latency"):
        cli.main(["run", job, "--latency", "0.1", "--device", "cpu"])


def test_fabric_kills_a_fleet_past_its_timeout(job):
    with pytest.raises(SystemExit, match="timeout after 0.5s"):
        cli.main(["fabric", job, "--device", "cpu", "--timeout", "0.5"])
