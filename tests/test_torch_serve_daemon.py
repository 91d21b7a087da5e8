"""The port's serve daemon and admission controller on the CPU
(``ServeDaemon(device="cpu")``), against the JAX package's where they
share a contract.

* Admission: the pool is never exceeded under contention; a job that can
  never fit, one that declines to queue and one that times out are
  rejected with the reference's messages; the byte cap holds.
* The daemon: a hot submit makes zero traces and zero plans (its own
  counters) and returns the cold plan and output digests, also for a
  two-party job executed through the half gates' plain versions and its
  cached batch schedule; an oversized job is rejected (``rejected``,
  exit 3 from ``submit``); bad requests get the reference's errors and
  the connection survives; a spec dict from the JAX package (with its
  ``plan_core``, ``sim_core``, ``chunk_instrs``) is accepted, with the
  reference daemon's digests; two clients are served at once; ``submit``
  and ``--status`` round-trip through the CLI.
* Without a card, a daemon made without ``device="cpu"`` raises.
"""

import json
import threading
import time

import pytest
import torch

from repro.api import JobSpec as RefJobSpec
from repro.serve_daemon.client import serve_client as ref_client
from repro.serve_daemon.server import ServeDaemon as RefDaemon
from repro_torch import __main__ as cli
from repro_torch.api import SCHEMA_VERSION, JobSpec
from repro_torch.serve_daemon import (AdmissionController, AdmissionError,
                                      ServeDaemon, ServeError, serve_client)

SPEC = JobSpec("merge", n=256, memory_budget=12, plan_mode="streaming")
#: in the clear: the plaintext driver, fast on the CPU
PLAIN = JobSpec("merge", n=256, memory_budget=12, plan_mode="streaming",
                driver="gc-plaintext")
#: two-party on the CPU: every AND call through the plain half gates
TWO_PARTY = JobSpec("aggsum", n=6, memory_budget=4, plan_mode="streaming")


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_never_exceeds_pool():
    ctl = AdmissionController(frame_pool=100)
    seen = []
    lock = threading.Lock()

    def job(frames):
        with ctl.admit(frames):
            with lock:
                seen.append(ctl.frames_in_use)
            time.sleep(0.002)

    threads = [threading.Thread(target=job, args=(f,))
               for f in (60, 60, 40, 40, 30, 30, 90, 10) * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ctl.frames_in_use == 0 and ctl.active == 0
    assert ctl.peak_frames <= 100 and max(seen) <= 100
    assert ctl.admitted == len(threads)


def test_admission_rejects_never_fits_no_queue_and_timeout():
    ctl = AdmissionController(frame_pool=10, max_queue=1)
    with pytest.raises(AdmissionError, match="never"):
        ctl.admit(11)
    with ctl.admit(8):
        with pytest.raises(AdmissionError, match="declined to queue"):
            ctl.admit(8, queue=False)
        with pytest.raises(AdmissionError, match="timed out"):
            ctl.admit(8, timeout=0.01)
    with ctl.admit(8):                       # drained: admits again
        pass
    assert ctl.rejected == 2 and ctl.status()["queued_peak"] == 1


def test_admission_memory_cap():
    ctl = AdmissionController(frame_pool=100, memory_bytes=1000)
    with pytest.raises(AdmissionError, match="memory budget"):
        ctl.admit(1, mem_bytes=2000)
    with ctl.admit(1, mem_bytes=900):
        with pytest.raises(AdmissionError):
            ctl.admit(1, mem_bytes=200, queue=False)
        assert ctl.status()["bytes_in_use"] == 900


# ---------------------------------------------------------------------------
# the daemon end to end
# ---------------------------------------------------------------------------


@pytest.fixture()
def daemon(tmp_path):
    d = ServeDaemon(tmp_path / "cache", socket_path=str(tmp_path / "m.sock"),
                    frame_pool=4096, device="cpu")
    d.start()
    yield d
    d.shutdown()


def test_hot_submit_zero_trace_zero_plan(daemon):
    with serve_client(daemon.address) as c:
        assert c.ping()["ok"]
        r1 = c.submit(PLAIN, execute=True, check=True)
        assert r1["cache"] == {"trace": "miss", "plan": "miss",
                               "batch": "miss"}
        before = c.status()["cache"]
        r2 = c.submit(PLAIN, execute=True, check=True)
        after = c.status()["cache"]
        assert r2["cache"] == {"trace": "skipped", "plan": "hit",
                               "batch": "hit"}
        assert r2["digests"] == r1["digests"]
        assert r2["outputs_digest"] == r1["outputs_digest"]
        assert r2["schema_version"] == SCHEMA_VERSION
        assert after["trace_misses"] == before["trace_misses"]
        assert after["plan_misses"] == before["plan_misses"]
        assert after["plan_hits"] == before["plan_hits"] + 1
        st = c.status()
        assert st["device"] == "cpu" and st["jobs"]["completed"] == 2


def test_hot_two_party_submit_equals_cold(daemon):
    """A GC job without a named driver runs two-party; the hot run's
    outputs equal the cold one's, every AND through the half gates."""
    with serve_client(daemon.address) as c:
        k0 = c.status()["kernels"]["gc"]
        cold = c.submit(TWO_PARTY, execute=True, check=True)
        hot = c.submit(TWO_PARTY, execute=True, check=True)
        k1 = c.status()["kernels"]["gc"]
    assert hot["cache"] == {"trace": "skipped", "plan": "hit",
                            "batch": "hit"}
    assert hot["outputs_digest"] == cold["outputs_digest"]
    assert hot["digests"] == cold["digests"]
    # the CPU runs the plain versions: no launch, every AND counted
    assert k1["garble_launches"] == k0["garble_launches"] == 0


def test_oversized_job_rejected(daemon, capsys):
    big = JobSpec("merge", n=256, memory_budget=100_000,
                  plan_mode="streaming")
    with serve_client(daemon.address) as c:
        with pytest.raises(ServeError, match="never") as ei:
            c.submit(big)
        assert ei.value.rejected
        assert c.status()["jobs"]["rejected"] == 1
    assert cli.main(["submit", "--connect", daemon.address, "--workload",
                     "merge", "-n", "256", "--budget", "100000"]) == 3
    assert "never be admitted" in capsys.readouterr().err


def test_bad_requests_get_the_references_errors(daemon):
    with serve_client(daemon.address) as c:
        with pytest.raises(ServeError, match="unknown op"):
            c.request({"op": "frobnicate"})
        with pytest.raises(ServeError, match="unknown submit fields"):
            c.request({"op": "submit", "spec": SPEC.to_dict(), "bogus": 1})
        with pytest.raises(ServeError, match="needs a 'spec' object"):
            c.request({"op": "submit"})
        with pytest.raises(ServeError, match="unknown JobSpec fields"):
            c.submit({"workload": "merge", "wat": 1})
        assert c.ping()["ok"]                # the connection survived


def test_reference_spec_accepted_with_the_references_digests(daemon,
                                                            tmp_path):
    ref = RefDaemon(tmp_path / "ref_cache",
                    socket_path=str(tmp_path / "r.sock"))
    ref.start()
    try:
        with ref_client(ref.address) as c:
            want = c.submit(RefJobSpec(**SPEC.to_dict() | {
                "exec_backend": "scalar"}))["digests"]
    finally:
        ref.shutdown()
    spec = RefJobSpec(workload="merge", n=256, memory_budget=12,
                      plan_mode="streaming", plan_core="scalar",
                      chunk_instrs=512).to_dict()
    with serve_client(daemon.address) as c:
        got = c.submit(spec)
        assert got["digests"] == want
        assert got["spec_hash"] == SPEC.plan_hash()
        assert c.submit(SPEC)["cache"]["plan"] == "hit"


def test_two_clients_served_at_once(daemon):
    out, errs = {}, []

    def client(name, spec):
        try:
            with serve_client(daemon.address) as c:
                out[name] = c.submit(spec, execute=True, check=True)
        except Exception as e:            # noqa: BLE001 (re-raised below)
            errs.append(e)

    specs = {"merge": PLAIN, "rsum": JobSpec("rsum", n=32, memory_budget=8,
                                             ckks_ring=128)}
    threads = [threading.Thread(target=client, args=kv)
               for kv in specs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and set(out) == set(specs)
    with serve_client(daemon.address) as c:
        st = c.status()
    assert st["jobs"]["completed"] == 2
    assert st["admission"]["admitted"] == 2
    assert st["admission"]["active"] == 0


def test_cli_submit_round_trip(daemon, tmp_path, capsys):
    out = tmp_path / "resp.json"
    assert cli.main(["submit", "--connect", daemon.address, "--workload",
                     "merge", "-n", "256", "--budget", "12", "--json",
                     str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["schema_version"] == 1
    assert doc["spec_hash"] == SPEC.plan_hash()
    assert cli.main(["submit", "--connect", daemon.address,
                     "--status"]) == 0
    assert '"plan_misses": 1' in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_daemon_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeDaemon(tmp_path / "cache", socket_path=str(tmp_path / "s"))
