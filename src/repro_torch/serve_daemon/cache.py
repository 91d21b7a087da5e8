"""On-disk artifact cache: traced bytecode, next-use sidecars, plans (the
port's copy of ``repro.serve_daemon.cache``, in its layout and format, so
either package hits the other's entries).

Planned memory programs are deterministic functions of the plan-relevant
spec fields (``JobSpec.plan_hash``) and traced bytecode of the trace-
relevant subset (``JobSpec.trace_hash``), so both are cacheable across
sessions, processes and daemon restarts.  Layout under one cache root::

    <root>/trace/<trace_hash>/manifest.json
                              worker0.virtual.bc    FREE-stripped bytecode
                              worker0.ann           next-use sidecar
    <root>/plan/<plan_hash>/manifest.json
                            worker0.memory.bc       planned memory program
    <root>/batch/<plan_hash>/manifest.json
                             worker0.batch.npz      exec/ batch schedule
    <root>/overlap/<plan_hash>/manifest.json
                               worker0.overlap.npz  exec/ overlap schedule

Every entry's manifest records the sha256 + byte size of each artifact
file, the spec that produced it, and (for plans) the resolved per-worker
``PlanConfig`` and ``PlanReport`` so a cache-hit Session can still
``simulate()``.  A hit is validated exactly like ``Session.from_plan``
— the key is recomputed from the manifest's spec, the stamped hash in
every program header must agree, and additionally every file must match
its recorded digest — so a tampered or truncated entry is *rejected and
deleted* (counted in ``stats.invalid``) and the caller transparently
re-traces/re-plans.

Eviction is LRU by entry (manifest mtime; hits ``os.utime`` it) and
runs after each put until the root is back under ``max_bytes``.  The
entry being written is never the victim.  Counters (hits, misses,
invalid, evictions, bytes) feed the daemon's ``status`` response.

Concurrency: one in-process lock serializes counter updates and
eviction; file writes build the entry under a temporary name and
``os.rename`` it into place, so readers only ever see complete entries
(a lost race to publish the same key keeps the winner's files).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading

from ..core.bytecode import (DEFAULT_CHUNK_INSTRS, ProgramFile,
                             strip_frees, write_program, writer_like)
from ..core.liveness import annotate_next_use
from ..core.planner import PlanConfig, PlanReport
from ..core.replacement import ReplacementStats
from ..core.scheduling import ScheduleStats

MANIFEST = "manifest.json"
CACHE_FORMAT = 1
#: Session.trace stamps these per-spec; the cached trace is the pure
#: function of the trace fields, so they are stripped before writing and
#: re-stamped by the consuming Session on a hit.
_SPEC_META_KEYS = ("spec_hash", "job_spec")


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/byte counters, exposed by the daemon's JSON status."""
    trace_hits: int = 0
    trace_misses: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    batch_hits: int = 0
    batch_misses: int = 0
    overlap_hits: int = 0
    overlap_misses: int = 0
    agg_hits: int = 0
    agg_misses: int = 0
    invalid: int = 0          # tampered/truncated entries rejected + deleted
    evictions: int = 0
    bytes_read: int = 0       # validated artifact bytes served from cache
    bytes_written: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _report_to_dict(rep: PlanReport) -> dict:
    return dataclasses.asdict(rep)


def _known(cls, d: dict) -> dict:
    """``d``'s keys that are fields of ``cls``: the JAX package's reports
    carry a ``placement_s`` the port's PlanReport has not."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _report_from_dict(d: dict) -> PlanReport:
    rep = dict(d)
    r, s = rep.pop("replacement", None), rep.pop("schedule", None)
    return PlanReport(
        replacement=ReplacementStats(**r) if r else None,
        schedule=ScheduleStats(**s) if s else None,
        **_known(PlanReport, rep))


class CacheEntryError(ValueError):
    """A cache entry failed validation (tampered, truncated, or stale)."""


class ArtifactCache:
    """Spec-hash-keyed cache of traced bytecode and planned programs."""

    def __init__(self, root: str | os.PathLike,
                 max_bytes: int | None = None):
        self.root = os.fspath(root)
        self.max_bytes = max_bytes
        self.stats = CacheStats()
        self._lock = threading.Lock()
        os.makedirs(os.path.join(self.root, "trace"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "plan"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "batch"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "overlap"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "agg"), exist_ok=True)

    # -- bookkeeping ---------------------------------------------------------

    def _entries(self) -> list[tuple[float, int, str]]:
        """(mtime, bytes, dir) per complete entry, oldest first."""
        out = []
        for kind in ("trace", "plan", "batch", "overlap", "agg"):
            base = os.path.join(self.root, kind)
            for name in os.listdir(base):
                d = os.path.join(base, name)
                man = os.path.join(d, MANIFEST)
                if not os.path.isfile(man):
                    continue          # incomplete / mid-publish
                size = sum(e.stat().st_size for e in os.scandir(d)
                           if e.is_file())
                out.append((os.stat(man).st_mtime, size, d))
        out.sort()
        return out

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def entry_count(self) -> int:
        return len(self._entries())

    def status(self) -> dict:
        return {"root": self.root, "max_bytes": self.max_bytes,
                "entries": self.entry_count(),
                "total_bytes": self.total_bytes(),
                **self.stats.to_dict()}

    def _evict(self, keep: str) -> None:
        """LRU-evict until under ``max_bytes``; never evicts ``keep``."""
        if self.max_bytes is None:
            return
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        keep = os.path.abspath(keep)
        for _, size, d in entries:
            if total <= self.max_bytes:
                break
            if os.path.abspath(d) == keep:
                continue
            shutil.rmtree(d, ignore_errors=True)
            total -= size
            self.stats.evictions += 1

    def _drop(self, entry_dir: str) -> None:
        with self._lock:
            self.stats.invalid += 1
        shutil.rmtree(entry_dir, ignore_errors=True)

    def _publish(self, tmp: str, entry_dir: str) -> None:
        """Atomically move a fully-built entry into place."""
        try:
            os.rename(tmp, entry_dir)
        except OSError:
            # lost a publish race (or a stale entry exists): keep theirs
            # if complete, replace if it is junk without a manifest
            if os.path.isfile(os.path.join(entry_dir, MANIFEST)):
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                shutil.rmtree(entry_dir, ignore_errors=True)
                os.rename(tmp, entry_dir)
        with self._lock:
            self._evict(keep=entry_dir)

    def _load(self, kind: str, key: str) -> tuple[str, dict] | None:
        """Validate and return (entry_dir, manifest) or None (= miss).

        Validation mirrors ``Session.from_plan``: the key is recomputed
        from the manifest's spec and every program's stamped hash must
        agree; additionally every artifact file must match its recorded
        sha256/size, so bit-level tampering is caught too."""
        entry_dir = os.path.join(self.root, kind, key)
        man_path = os.path.join(entry_dir, MANIFEST)
        if not os.path.isfile(man_path):
            return None
        try:
            with open(man_path) as f:
                manifest = json.load(f)
            if manifest.get("format") != CACHE_FORMAT or \
                    manifest.get("kind") != kind:
                raise CacheEntryError("wrong manifest format")
            if kind == "agg":
                from ..aggregate.offline import AggSpec
                expect = AggSpec.from_dict(manifest["spec"]).plan_key()
            else:
                from ..api import JobSpec
                spec = JobSpec.from_dict(manifest["spec"])
                expect = spec.trace_hash() if kind == "trace" \
                    else spec.plan_hash()
            if manifest.get("key") != key or expect != key:
                raise CacheEntryError(
                    f"manifest spec hashes to {expect}, entry claims "
                    f"{manifest.get('key')} ({key})")
            nread = 0
            for name, rec in manifest["files"].items():
                path = os.path.join(entry_dir, name)
                if not os.path.isfile(path) or \
                        os.path.getsize(path) != rec["bytes"] or \
                        _sha256(path) != rec["sha256"]:
                    raise CacheEntryError(f"{name} does not match its "
                                          f"recorded digest")
                nread += rec["bytes"]
            for name in manifest["programs"]:
                pf = ProgramFile(os.path.join(entry_dir, name))
                stamped = pf.meta.get("trace_hash") if kind == "trace" \
                    else pf.meta.get("spec_hash")
                if stamped != key:
                    raise CacheEntryError(
                        f"{name} was produced for {stamped}, entry says "
                        f"{key} — artifact and spec disagree")
        except (OSError, ValueError, KeyError, TypeError):
            # CacheEntryError is a ValueError: tampered/truncated/stale
            # entries are deleted so the caller re-traces/re-plans
            self._drop(entry_dir)
            return None
        os.utime(man_path)            # LRU touch
        with self._lock:
            self.stats.bytes_read += nread
        return entry_dir, manifest

    def _write_manifest(self, tmp: str, manifest: dict) -> None:
        files = {}
        nbytes = 0
        for e in os.scandir(tmp):
            if e.is_file():
                files[e.name] = {"sha256": _sha256(e.path),
                                 "bytes": e.stat().st_size}
                nbytes += e.stat().st_size
        manifest["format"] = CACHE_FORMAT
        manifest["files"] = files
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        with self._lock:
            self.stats.bytes_written += nbytes

    def _tmpdir(self, kind: str) -> str:
        return tempfile.mkdtemp(prefix=".tmp-", dir=os.path.join(self.root,
                                                                 kind))

    # -- traced bytecode + next-use sidecars ---------------------------------

    def get_trace(self, spec, workload=None
                  ) -> tuple[list[ProgramFile], list[str]] | None:
        """Cached (programs, sidecar paths) for the spec's trace shape."""
        key = spec.trace_hash(workload)
        got = self._load("trace", key)
        with self._lock:
            if got is None:
                self.stats.trace_misses += 1
            else:
                self.stats.trace_hits += 1
        if got is None:
            return None
        entry_dir, manifest = got
        progs = [ProgramFile(os.path.join(entry_dir, n))
                 for n in manifest["programs"]]
        anns = [os.path.join(entry_dir, n)
                for n in manifest["annotations"]]
        return progs, anns

    def put_trace(self, spec, workload, progs,
                  chunk_instrs: int = DEFAULT_CHUNK_INSTRS
                  ) -> tuple[list[ProgramFile], list[str]]:
        """Cache freshly traced programs; returns the cache-resident
        (FREE-stripped) files + sidecars, which the session adopts so
        the cold path annotates exactly once."""
        key = spec.trace_hash(workload)
        entry_dir = os.path.join(self.root, "trace", key)
        tmp = self._tmpdir("trace")
        try:
            names, ann_names = [], []
            for i, prog in enumerate(progs):
                name, ann = f"worker{i}.virtual.bc", f"worker{i}.ann"
                meta = {k: v for k, v in prog.meta.items()
                        if k not in _SPEC_META_KEYS}
                meta["trace_hash"] = key
                w = writer_like(prog, os.path.join(tmp, name), meta=meta,
                                chunk_instrs=chunk_instrs)
                w.extend(strip_frees(prog.instrs))
                pf = w.close()
                annotate_next_use(pf, os.path.join(tmp, ann), chunk_instrs)
                names.append(name)
                ann_names.append(ann)
            self._write_manifest(tmp, {
                "kind": "trace", "key": key,
                "spec": spec.normalized(workload).to_dict(),
                "programs": names, "annotations": ann_names})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._publish(tmp, entry_dir)
        progs = [ProgramFile(os.path.join(entry_dir, n)) for n in names]
        anns = [os.path.join(entry_dir, n) for n in ann_names]
        return progs, anns

    # -- planned memory programs ---------------------------------------------

    def get_plan(self, spec, workload=None
                 ) -> tuple[list[ProgramFile], list[PlanConfig],
                            list[PlanReport]] | None:
        """Cached (memory programs, resolved configs, plan reports)."""
        key = spec.plan_hash(workload)
        got = self._load("plan", key)
        with self._lock:
            if got is None:
                self.stats.plan_misses += 1
            else:
                self.stats.plan_hits += 1
        if got is None:
            return None
        entry_dir, manifest = got
        progs = [ProgramFile(os.path.join(entry_dir, n))
                 for n in manifest["programs"]]
        cfgs = [PlanConfig(**_known(PlanConfig, d))
                for d in manifest["plan_configs"]]
        reports = [_report_from_dict(d) for d in manifest["reports"]]
        return progs, cfgs, reports

    # -- batch schedules (exec/ backend sidecars) ----------------------------

    def get_batch(self, spec, workload=None):
        """Cached per-worker :class:`~..exec.batching.BatchSchedule`
        sidecars for the spec's plan shape, or None.  Keyed by
        ``plan_hash``: the schedule is a deterministic function of the
        planned memory program, which is itself keyed the same way."""
        from ..exec.batching import BatchSchedule
        key = spec.plan_hash(workload)
        got = self._load("batch", key)
        with self._lock:
            if got is None:
                self.stats.batch_misses += 1
            else:
                self.stats.batch_hits += 1
        if got is None:
            return None
        entry_dir, manifest = got
        try:
            return [BatchSchedule.load(os.path.join(entry_dir, n))
                    for n in manifest["schedules"]]
        except (OSError, ValueError, KeyError):
            self._drop(entry_dir)
            return None

    def put_batch(self, spec, workload, schedules) -> None:
        """Cache freshly built batch schedules (one npz per worker)."""
        key = spec.plan_hash(workload)
        entry_dir = os.path.join(self.root, "batch", key)
        tmp = self._tmpdir("batch")
        try:
            names = []
            for i, sched in enumerate(schedules):
                name = f"worker{i}.batch.npz"
                sched.save(os.path.join(tmp, name))
                names.append(name)
            # "programs" is always present (entry validation iterates it);
            # batch entries carry sidecars, not bytecode
            self._write_manifest(tmp, {
                "kind": "batch", "key": key,
                "spec": spec.normalized(workload).to_dict(),
                "programs": [], "schedules": names})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._publish(tmp, entry_dir)

    # -- overlap schedules (exec/ overlap backend sidecars) ------------------

    def get_overlap(self, spec, workload=None):
        """Cached per-worker :class:`~..exec.overlap.OverlapSchedule`
        sidecars for the spec's plan shape, or None.  Keyed by
        ``plan_hash`` like the batch sidecars: the schedule is a
        deterministic function of the planned memory program."""
        from ..exec.overlap import OverlapSchedule
        key = spec.plan_hash(workload)
        got = self._load("overlap", key)
        with self._lock:
            if got is None:
                self.stats.overlap_misses += 1
            else:
                self.stats.overlap_hits += 1
        if got is None:
            return None
        entry_dir, manifest = got
        try:
            return [OverlapSchedule.load(os.path.join(entry_dir, n))
                    for n in manifest["schedules"]]
        except (OSError, ValueError, KeyError):
            self._drop(entry_dir)
            return None

    def put_overlap(self, spec, workload, schedules) -> None:
        """Cache freshly built overlap schedules (one npz per worker)."""
        key = spec.plan_hash(workload)
        entry_dir = os.path.join(self.root, "overlap", key)
        tmp = self._tmpdir("overlap")
        try:
            names = []
            for i, sched in enumerate(schedules):
                name = f"worker{i}.overlap.npz"
                sched.save(os.path.join(tmp, name))
                names.append(name)
            # "programs" is always present (entry validation iterates it)
            self._write_manifest(tmp, {
                "kind": "overlap", "key": key,
                "spec": spec.normalized(workload).to_dict(),
                "programs": [], "schedules": names})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._publish(tmp, entry_dir)

    # -- secure-aggregation round plans (``aggregate``) ------------------

    def get_agg(self, spec) -> dict | None:
        """Cached round-plan document for an ``AggSpec``, or None.  Keyed
        by ``AggSpec.plan_key()``: the plan is a pure function of the
        plan-relevant spec fields (the aggregation schedule is oblivious,
        so it is derived entirely ahead of time)."""
        key = spec.plan_key()
        got = self._load("agg", key)
        with self._lock:
            if got is None:
                self.stats.agg_misses += 1
            else:
                self.stats.agg_hits += 1
        if got is None:
            return None
        entry_dir, manifest = got
        try:
            with open(os.path.join(entry_dir, "roundplan.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            self._drop(entry_dir)
            return None

    def put_agg(self, spec, plan_doc: dict) -> None:
        """Cache a freshly derived round plan (one JSON sidecar)."""
        key = spec.plan_key()
        entry_dir = os.path.join(self.root, "agg", key)
        tmp = self._tmpdir("agg")
        try:
            with open(os.path.join(tmp, "roundplan.json"), "w") as f:
                json.dump(plan_doc, f, indent=2)
            # "programs" is always present (entry validation iterates it)
            self._write_manifest(tmp, {
                "kind": "agg", "key": key, "spec": spec.to_dict(),
                "programs": [], "artifacts": ["roundplan.json"]})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._publish(tmp, entry_dir)

    def put_plan(self, spec, workload, planned, cfgs, reports) -> None:
        """Cache planned memory programs (files are copied, the session
        keeps executing its own artifacts)."""
        key = spec.plan_hash(workload)
        entry_dir = os.path.join(self.root, "plan", key)
        tmp = self._tmpdir("plan")
        try:
            names = []
            for i, p in enumerate(planned):
                name = f"worker{i}.memory.bc"
                dst = os.path.join(tmp, name)
                if isinstance(p, ProgramFile):
                    shutil.copyfile(p.path, dst)
                else:
                    write_program(p, dst)
                names.append(name)
            self._write_manifest(tmp, {
                "kind": "plan", "key": key,
                "spec": spec.normalized(workload).to_dict(),
                "programs": names,
                "plan_configs": [dataclasses.asdict(c) for c in cfgs],
                "reports": [_report_to_dict(r) for r in reports]})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._publish(tmp, entry_dir)
