"""Build the CUDA sources under csrc/ and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

The hash covers the sources and the flags, so an edited source is rebuilt
at its next use. Every source is compiled by its own nvcc process, all
started together. Nothing is built when this module is imported: the first
kernel launch builds what it needs, and `build()` builds everything up
front. The build directory is listed in .gitignore.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[str]:
    """Names of the kernel sources (csrc/<name>.cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, tuple[float, str]]:
    """Compile the named sources (default: all) that are not built yet.

    The nvcc processes run in parallel. Returns {name: (seconds, compiler
    log)} for each source compiled; raises with nvcc's output on failure.
    """
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            time.perf_counter(), tmp, out,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    done, failed = {}, []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()  # every nvcc is waited for
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
