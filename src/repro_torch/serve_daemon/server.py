"""The multi-tenant serving daemon behind ``python -m repro_torch serve``
(the port's copy of ``repro.serve_daemon.server``).

One long-running process owns an :class:`~.cache.ArtifactCache` and an
:class:`~.admission.AdmissionController` and answers line-delimited JSON
requests over a local socket (unix path, or TCP on localhost):

    {"op": "submit", "spec": {...}, "execute": true, ...}\\n
    {"op": "status"}\\n | {"op": "ping"}\\n | {"op": "shutdown"}\\n

Each connection is served by its own thread and may pipeline many
requests; a ``submit`` runs the staged Session pipeline with the shared
cache, so a repeated job shape is served from cached artifacts with
zero tracing and zero planning.  Planning and execution run only under
an admission reservation sized by the job's resolved frame count (on the
card the engine's frames live in device memory), so concurrent tenants
cannot overcommit the shared frame pool.

Every Session runs on the daemon's device: the card unless the daemon
was made with ``device="cpu"``.  An executed garbled-circuit job runs
two-party crypto, every AND gate through the half-gates kernels, unless
its spec names a driver (``gc-plaintext`` runs the clear); a CKKS job's
transforms and products go through the NTT kernels.  A spec from the JAX
package may carry its ``plan_core``, ``sim_core`` and ``chunk_instrs``;
they are read and ignored.  ``status`` also reports the daemon's device
and its kernels' counters (``kernels.kernel_counts``).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
import traceback

import numpy as np
import torch

from ..api import (SCHEMA_VERSION, JobSpec, Session, SpecMismatchError,
                   estimate_job_resources)
from ..core.bytecode import ProgramFile, iter_record_chunks
from ..core.liveness import file_digest, records_digest
from ..kernels import kernel_counts, resolve_device
from .admission import AdmissionController, AdmissionError
from .cache import ArtifactCache

#: request fields a submit accepts (anything else is rejected: the
#: protocol is versioned via schema_version, not silently lenient)
_SUBMIT_FIELDS = {"op", "spec", "execute", "check", "queue", "timeout",
                  "use_cache", "return_outputs"}


def program_digest(p) -> str:
    """Chunk-size-independent record digest of a planned program, hex.

    Equal iff the programs are bitwise-identical record streams: the
    hot-against-cold check of the cache."""
    if isinstance(p, ProgramFile):
        return f"{file_digest(p) & (1 << 64) - 1:016x}"
    d = 0
    for s, rec, _instrs in iter_record_chunks(p):
        d = records_digest(d, rec, s)
    return f"{d & (1 << 64) - 1:016x}"


def _outputs_digest(outputs) -> str:
    h = hashlib.sha256()
    for tag in sorted(outputs):
        h.update(str(tag).encode())
        h.update(np.ascontiguousarray(outputs[tag]).tobytes())
    return h.hexdigest()[:16]


class ServeDaemon:
    """Accept loop + per-connection request threads over one cache."""

    def __init__(self, cache_dir: str | os.PathLike,
                 socket_path: str | None = None,
                 host: str = "127.0.0.1", port: int | None = None,
                 frame_pool: int = 1 << 16,
                 memory_bytes: int | None = None,
                 cache_bytes: int | None = None,
                 max_queue: int = 64,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cache = ArtifactCache(cache_dir, max_bytes=cache_bytes)
        self.admission = AdmissionController(frame_pool,
                                             memory_bytes=memory_bytes,
                                             max_queue=max_queue)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._jobs = {"submitted": 0, "completed": 0, "failed": 0,
                      "rejected": 0}
        self._job_seq = 0
        self._stop = threading.Event()
        if socket_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            if os.path.exists(socket_path):
                os.unlink(socket_path)      # stale socket from a dead daemon
            self._sock.bind(socket_path)
            self.address: str | tuple[str, int] = socket_path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port or 0))
            self.address = self._sock.getsockname()
        self._sock.listen(64)

    # -- lifecycle -----------------------------------------------------------

    def serve_forever(self) -> None:
        """Accept connections until :meth:`shutdown`; blocks the caller."""
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break                      # listener closed by shutdown()
            if self._stop.is_set():        # shutdown()'s wake-up call
                conn.close()
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
        self._sock.close()

    def start(self) -> threading.Thread:
        """Run :meth:`serve_forever` on a background thread (tests)."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self._stop.set()
        # wake a thread blocked in accept(): not every kernel does for
        # shutdown() of a listening socket, so connect once
        try:
            family = socket.AF_UNIX if isinstance(self.address, str) \
                else socket.AF_INET
            with socket.socket(family, socket.SOCK_STREAM) as s:
                s.settimeout(1.0)
                s.connect(self.address)
        except OSError:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if isinstance(self.address, str) and os.path.exists(self.address):
            os.unlink(self.address)

    # -- request handling ----------------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn, conn.makefile("r", encoding="utf-8") as rf:
            for line in rf:
                line = line.strip()
                if not line:
                    continue
                try:
                    resp = self._dispatch(json.loads(line))
                except Exception as e:     # noqa: BLE001 (protocol boundary)
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc(limit=4)}
                resp.setdefault("schema_version", SCHEMA_VERSION)
                try:
                    conn.sendall((json.dumps(resp) + "\n").encode())
                except OSError:
                    return
                if resp.get("op") == "shutdown":
                    self.shutdown()
                    return

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        if op == "status":
            return self.status()
        if op == "submit":
            return self._submit(req)
        return {"ok": False, "error": f"unknown op {op!r} (expected "
                                      f"submit|status|ping|shutdown)"}

    def status(self) -> dict:
        with self._lock:
            jobs = dict(self._jobs)
        return {"ok": True, "op": "status",
                "uptime_s": time.monotonic() - self._t0,
                "jobs": jobs, "cache": self.cache.status(),
                "admission": self.admission.status(),
                "device": str(self.device), "kernels": kernel_counts()}

    def _count(self, key: str) -> None:
        with self._lock:
            self._jobs[key] += 1

    def _submit(self, req: dict) -> dict:
        unknown = set(req) - _SUBMIT_FIELDS
        if unknown:
            return {"ok": False,
                    "error": f"unknown submit fields {sorted(unknown)}"}
        if not isinstance(req.get("spec"), dict):
            return {"ok": False, "error": "submit needs a 'spec' object"}
        spec = JobSpec.from_dict(req["spec"])
        # a GC job runs two-party crypto unless its spec names a driver
        real = True if spec.driver == "auto" else None
        with self._lock:
            self._job_seq += 1
            job_id = self._job_seq
        self._count("submitted")
        t_start = time.perf_counter()
        cache = self.cache if req.get("use_cache", True) else None
        try:
            with Session(spec, device=self.device, cache=cache) as sess:
                frames, mem_bytes = estimate_job_resources(sess)
                t_admit = time.perf_counter()
                try:
                    grant = self.admission.admit(
                        frames, mem_bytes, queue=req.get("queue", True),
                        timeout=req.get("timeout"))
                except AdmissionError as e:
                    self._count("rejected")
                    return {"ok": False, "op": "submit", "job_id": job_id,
                            "rejected": True, "error": str(e)}
                queued_s = time.perf_counter() - t_admit
                with grant:
                    t_plan = time.perf_counter()
                    planned = sess.plan()
                    plan_s = time.perf_counter() - t_plan
                    digests = [program_digest(p) for p in planned]
                    resp = {
                        "ok": True, "op": "submit", "job_id": job_id,
                        "spec_hash": sess.spec.plan_hash(sess.workload),
                        "trace_hash": sess.spec.trace_hash(sess.workload),
                        "cache": {"trace": sess.cache_events.get(
                                      "trace", "skipped"),
                                  "plan": sess.cache_events.get(
                                      "plan", "skipped")},
                        "frames": frames,
                        "memory_estimate_bytes": mem_bytes,
                        "digests": {"plan": digests},
                        "timings": {"queued_s": queued_s,
                                    "plan_s": plan_s},
                    }
                    if req.get("execute", False):
                        t_exec = time.perf_counter()
                        outputs = sess.execute(
                            real=real, check=req.get("check", False))
                        resp["timings"]["execute_s"] = \
                            time.perf_counter() - t_exec
                        resp["outputs_digest"] = _outputs_digest(outputs)
                        # the schedule cache the engine loop consults
                        kind = {"batched": "batch", "overlap": "overlap"
                                }.get(sess.spec.exec_backend)
                        if kind is not None:
                            resp["cache"][kind] = \
                                sess.cache_events.get(kind, "skipped")
                        if req.get("return_outputs", False):
                            resp["outputs"] = {
                                str(t): np.asarray(v).tolist()
                                for t, v in outputs.items()}
            resp["timings"]["total_s"] = time.perf_counter() - t_start
            self._count("completed")
            return resp
        except (SpecMismatchError, ValueError, KeyError,
                AssertionError) as e:
            self._count("failed")
            return {"ok": False, "op": "submit", "job_id": job_id,
                    "error": f"{type(e).__name__}: {e}"}
