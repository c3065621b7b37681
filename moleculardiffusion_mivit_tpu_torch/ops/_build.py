"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file compiles on its own, with ``nvcc`` for ``sm_90a``,
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds rather than minutes). All sources build in parallel, one
``nvcc`` process each, at the first call that needs any of them. Libraries
land in ``build/kernels/`` at the root of the checkout, named by a hash of
every source and the flags, so an edited source rebuilds and an unchanged one
is reused. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_source_hash()}.so"


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, all at once. Returns each
    source's ``-Xptxas -v`` report (registers, shared memory, spills) for the
    sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not _lib_path(s.stem).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        tmp = _lib_path(src.stem).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[stem] = out
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(stem))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building first if
    needed."""
    if stem not in _loaded:
        path = _lib_path(stem)
        if not path.exists():
            build_all()
        _loaded[stem] = ctypes.CDLL(str(path))
    return _loaded[stem]
