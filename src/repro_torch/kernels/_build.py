"""Build the port's CUDA sources into shared libraries, at first use.

Each library is one ``nvcc -shared`` call over the ``.cu`` files of a
``csrc/`` directory, for ``sm_90a``, with a plain C interface that the
kernel modules load with ``ctypes`` (no PyTorch headers: the build takes
seconds, not minutes).  Outputs go to ``build/torch_ext/`` at the root of
the checkout, named by a digest of the sources and flags, so an unchanged
source is built once and a changed one is rebuilt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    log: str                # nvcc/ptxas output (registers, spills), also
                            # of a reused build


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA toolkit is needed to build the kernels")


def build(name: str, csrc: Path) -> Built:
    """Compile every ``.cu`` in ``csrc`` into ``lib<name>-<digest>.so``."""
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {csrc}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")    # what the compiler said, kept
    if out.exists():
        return Built(out, 0.0, log_path.read_text()
                     if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{csrc}", "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return Built(out, seconds, log)
