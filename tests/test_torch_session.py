"""The port's Session, end to end on the CPU (the plain half gates), against
the JAX package's two-party batched Session on the same job: a merge whose
budget forces swaps.  Outputs, AND gates and garbled-table traffic must be
equal; entry points without a device must refuse to fall back."""

import threading

import numpy as np
import pytest
import torch

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.storage import PinnedStorage, SwapIO
from repro_torch.core.transport import (InprocTransport, TransportClosed,
                                        TransportError)
from repro_torch.kernels import resolve_device

JOB = dict(n=64, memory_budget=5, lookahead=10_000, prefetch_pages=1)
TAB = 1          # the garbled-table tag of the party channel, in both packages


def _tables(stats) -> tuple[int, int]:
    msgs = sum(v.messages for k, v in stats.items() if k[2] == TAB)
    return msgs, sum(v.bytes for k, v in stats.items() if k[2] == TAB)


@pytest.fixture(scope="module")
def reference():
    s = RefSession(RefJobSpec(workload="merge", driver="gc-2party",
                              exec_backend="batched", **JOB))
    out = s.execute(check=True)
    return out, _tables(s.transport_stats)


def test_session_matches_reference(reference):
    ref_out, (ref_msgs, ref_bytes) = reference
    s = Session(JobSpec("merge", **JOB), device="cpu")
    out = s.execute(real=True, check=True)
    assert all(e.swap_ins > 0 and e.swap_outs > 0 for e in s.engine_stats)
    assert sorted(out) == sorted(ref_out)
    assert all(np.array_equal(out[k], ref_out[k]) for k in ref_out)
    g, e = s.gate_counts
    assert g.ands == e.ands == ref_bytes // 32
    assert _tables(s.transport_stats) == (ref_msgs, ref_bytes)
    assert s.timings["execute_s"] > 0 and s.table_digest is None


def test_cli_run_on_cpu(capsys):
    argv = ["exec", "--workload", "merge", "-n", "32", "--budget", "6",
            "--prefetch", "1", "--check", "--device", "cpu"]
    assert cli.main(argv) == 0                     # the plaintext oracle
    assert '"driver": "gc-plaintext"' in capsys.readouterr().out
    assert cli.main(argv + ["--real"]) == 0
    assert '"checked": true' in capsys.readouterr().out


def test_no_cuda_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = JobSpec("merge", **JOB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        Session(spec)
    with pytest.raises(RuntimeError):
        Session(spec, device="cuda")
    assert Session(spec, device="cpu").plan()[0].phase == "memory"


@pytest.mark.parametrize("bad", [dict(memory_budget=None),
                                 dict(memory_budget=1.5)])
def test_jobspec_rejects_bad_budgets(bad):
    with pytest.raises(ValueError):
        JobSpec("merge", **{**JOB, **bad})


def test_swap_io_moves_pages():
    """Every swap directive's data path (the CPU branch; the card's is
    driven by chip_smoke.py), with its byte accounting."""
    dev = torch.device("cpu")
    io = SwapIO(PinnedStorage([3, 7], (4, 2), torch.int64, dev),
                torch.zeros((2, 4, 2), dtype=torch.int64), dev)
    frame = torch.arange(8, dtype=torch.int64).view(4, 2)
    io.write_sync(3, frame)                        # SWAP_OUT
    io.copy_out(1, frame * 2)                      # COPY_OUT
    io.issue_write(7, 1)                           # ISSUE_SWAP_OUT
    a, b = torch.zeros_like(frame), torch.zeros_like(frame)
    io.read_sync(3, a)                             # SWAP_IN
    io.issue_read(7, 0)                            # ISSUE_SWAP_IN
    io.finish_read(0, b)                           # FINISH_SWAP_IN
    io.close()
    assert torch.equal(a, frame) and torch.equal(b, frame * 2)
    assert io.bytes_read == io.bytes_written == 2 * 4 * 2 * 8
    with pytest.raises(KeyError):
        io.issue_read(5, 0)


def test_transport_parties_take_turns():
    """Each endpoint thread holds the baton while it runs; a sender blocked
    by the depth bound gives it up, so its receiver gets to run."""
    t = InprocTransport(2)
    t.set_depth(0, 1, max_msgs=2)
    got, holders = [], []

    def party(fn):
        with t.baton:
            fn()
            holders.append(t.baton.locked())

    def send():
        for k in range(6):
            t.send(0, 1, 1, torch.full((2,), k))

    def recv():
        got.extend(int(t.recv(0, 1, 1, timeout=10)[0]) for _ in range(6))

    threads = [threading.Thread(target=party, args=(f,)) for f in (send, recv)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert got == list(range(6)) and holders == [True, True]
    assert not t.baton.locked()
    assert t.stats()[(0, 1, 1)].bytes == 6 * 2 * 8


def test_transport_timeout_and_close_keep_the_baton():
    """A receive that times out, or finds its link closed, raises and leaves
    the caller holding the baton again."""
    t = InprocTransport(2)
    with t.baton:
        with pytest.raises(TransportError, match="timed out"):
            t.recv(0, 1, 1, timeout=0.05)
        assert t.baton.locked()
        threading.Timer(0.05, t.close).start()
        with pytest.raises(TransportClosed):
            t.recv(0, 1, 1)
        assert t.baton.locked()
    with pytest.raises(TransportError, match="bad link"):
        t.send(0, 0, 1, torch.zeros(1))
