"""ctypes bindings for the port's native frame IO (`yuv_io.cc`).

The library is built with the host's g++ at its first use,

    g++ -O2 -std=c++17 -shared -fPIC -o build/libme_io-<hash>.so yuv_io.cc

where the hash covers the source, the flags and the compiler's version, so
an edited source is rebuilt. Each build writes a file of its own and
installs it by an atomic rename, so processes that build at the same moment
(test workers) each load a whole library. A failed build raises with the
compiler's output: nothing falls back to another path. The build
directory is listed in .gitignore.

Every entry point returns 0 or a negative errno; the wrappers raise
`OSError` (`FileNotFoundError` for a missing file) on an error code.
"""
from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "yuv_io.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: list[ctypes.CDLL] = []


def compiler() -> str:
    """Path of the host's g++; raises without one."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the native frame IO (io_native/yuv_io.cc) "
            "cannot be built")
    return found


def library_path(cxx: str) -> Path:
    """build/libme_io-<hash>.so for the source, flags and compiler `cxx`."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(version.encode())
    return BUILD_DIR / f"libme_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library's path, compiling it first if it is missing;
    raises with g++'s output when the compile fails."""
    cxx = compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for io_native/yuv_io.cc:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    with _lock:
        if not _loaded:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            signatures = {
                "me_read_frame_u8": [ctypes.c_char_p, i64, i64, u8p],
                "me_write_frame_i32": [ctypes.c_char_p, i32p, i64],
                "me_stack_output": [i32p, i32p, i32p, i64, i64, i32p],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded.append(lib)
        return _loaded[0]


def _check(rc: int, what: str, path=None) -> None:
    if rc != 0:
        raise OSError(-rc, f"{what} failed with native error {rc} "
                      f"({os.strerror(-rc)})", path)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def read_frame_into(path: str | os.PathLike, out: np.ndarray) -> np.ndarray:
    """Read the first H*W bytes of a raw YUV file into a caller-owned
    C-contiguous [H, W] uint8 buffer; a file shorter than that raises
    OSError (EINVAL)."""
    if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous [H, W] uint8 array")
    if not out.flags.writeable:
        raise ValueError("out must be writable")
    h, w = out.shape
    rc = _lib().me_read_frame_u8(os.fsencode(path), h, w, out)
    if rc == -errno.EINVAL:
        raise OSError(errno.EINVAL, f"{path}: expected at least {h * w} "
                      f"bytes for {w}x{h} luma", os.fspath(path))
    _check(rc, "read_frame", os.fspath(path))
    return out


def read_frame(path: str | os.PathLike, height: int, width: int) -> np.ndarray:
    return read_frame_into(path, np.empty((height, width), np.uint8))


def write_frame(path: str | os.PathLike, frame_i32: np.ndarray) -> None:
    """Write an int32 frame as raw u8 bytes, narrowed mod 256."""
    data = _i32(frame_i32)
    _check(_lib().me_write_frame_i32(os.fsencode(path), data.reshape(-1),
                                     data.size),
           "write_frame", os.fspath(path))


def stack_output(ref: np.ndarray, cur: np.ndarray,
                 comp: np.ndarray) -> np.ndarray:
    """The [5*H, W] int32 stack [ref, cur, comp, |ref-cur|, |comp-cur|] of
    three [H, W] frames."""
    ref, cur, comp = _i32(ref), _i32(cur), _i32(comp)
    if not ref.ndim == 2 or not ref.shape == cur.shape == comp.shape:
        raise ValueError(f"stack_output of {ref.shape}, {cur.shape}, "
                         f"{comp.shape}: three equal [H, W] frames needed")
    h, w = ref.shape
    out = np.empty((5 * h, w), np.int32)
    _check(_lib().me_stack_output(ref, cur, comp, h, w, out), "stack_output")
    return out
