"""Raw YUV (luma plane) frame I/O and host-side frame ops.

`load_yuv`, `load_yuv_into`, `save_yuv` and `stack_output` run through the
native frame IO (`io_native`, built with g++ at first use; a failed build
raises). Their numpy bodies stay beside them as the plain versions
(`load_yuv_np`, `load_yuv_into_np`, `save_yuv_np`, `stack_output_np`),
which give the same bytes.

Reference semantics reproduced:

* ``yuvReadFrame`` reads exactly H*W bytes from the start of the file
  (`load_yuv`, or `load_yuv_into` a caller's buffer).
* ``yuvWriteFrame`` narrows int -> u8 with a plain C cast (modulo 256).
* ``frameDiff`` is |a - b|.
* ``imagePSNR`` uses the *observed* max pixel of either frame (not 255),
  double-precision MSE, returns 99.0 when MSE == 0, and
  psnr = 20*log10(MAX) - 10*log10(MSE).
* The emitted artifact is a 5-frame vertical stack
  [ref, cur, compensated, |ref-cur|, |comp-cur|] named
  ``output_<blk>_<span>.yuv``.
"""
from __future__ import annotations

import math
import os

import numpy as np

from motionestimation_tpu_torch import io_native


def load_yuv(path: str | os.PathLike, height: int, width: int) -> np.ndarray:
    """Read the first H*W bytes of a raw YUV file as a [H, W] uint8 plane
    (a writable array, so `torch.from_numpy` takes it without a copy)."""
    return load_yuv_into(path, np.empty((height, width), np.uint8))


def load_yuv_into(path: str | os.PathLike, out: np.ndarray) -> np.ndarray:
    """`load_yuv` into a caller-owned [H, W] uint8 buffer (no allocation),
    by the native mmap reader; a short file raises OSError.

    Same bytes as `load_yuv`; the GOP reader recycles a fixed pool of
    (pinned) buffers through it, so no 4K frame pays for a fresh
    allocation's page faults."""
    return io_native.read_frame_into(path, out)


def load_yuv_np(path: str | os.PathLike, height: int,
                width: int) -> np.ndarray:
    """The plain version of `load_yuv` (numpy, `readinto`)."""
    return load_yuv_into_np(path, np.empty((height, width), np.uint8))


def load_yuv_into_np(path: str | os.PathLike, out: np.ndarray) -> np.ndarray:
    """The plain version of `load_yuv_into`; a short file raises IOError."""
    if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous [H, W] uint8 array")
    with open(path, "rb") as f:
        got = f.readinto(out.reshape(-1))
    if got < out.size:
        h, w = out.shape
        raise IOError(
            f"{path}: expected at least {out.size} bytes for {w}x{h} luma, "
            f"got {got}"
        )
    return out


def load_yuv_rows(path: str | os.PathLike, height: int, width: int,
                  row_lo: int, row_hi: int) -> np.ndarray:
    """Rows [row_lo, row_hi) of a [height, width] luma plane, as a [rows,
    width] uint8 array: one seek and one read, so a process of a sharded
    run reads only the rows its mesh slots own
    (`parallel.ingest.local_row_range`). Raises on a short file."""
    if not 0 <= row_lo <= row_hi <= height:
        raise ValueError(
            f"row range [{row_lo}, {row_hi}) outside [0, {height}]")
    out = np.empty((row_hi - row_lo, width), np.uint8)
    if not out.size:
        return out
    with open(path, "rb") as f:
        f.seek(row_lo * width)
        got = f.readinto(out.reshape(-1))
    if got < out.size:
        raise IOError(
            f"{path}: expected {out.size} bytes for rows [{row_lo}, "
            f"{row_hi}) of {width}x{height} luma, got {got}")
    return out


def save_yuv(path: str | os.PathLike, frame: np.ndarray) -> None:
    """Write an integer frame as raw u8 bytes (C-cast narrowing), by the
    native writer."""
    io_native.write_frame(path, np.asarray(frame).astype(np.int32, copy=False))


def save_yuv_np(path: str | os.PathLike, frame: np.ndarray) -> None:
    """The plain version of `save_yuv`."""
    data = np.asarray(frame)
    if data.dtype != np.uint8:
        data = data.astype(np.uint8)  # wraps mod 256 like the C cast
    with open(path, "wb") as f:
        f.write(data.tobytes())


def frame_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| elementwise in int32."""
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def image_psnr(frame1: np.ndarray, frame2: np.ndarray) -> float:
    """PSNR with the reference's exact conventions.

    MAX is the maximum observed sample of either frame, MSE accumulates
    |diff|^2 in float64, MSE == 0 returns 99.0.
    """
    a = frame1.astype(np.int64).ravel()
    b = frame2.astype(np.int64).ravel()
    max_val = int(max(a.max(initial=0), b.max(initial=0)))
    diff = np.abs(a - b).astype(np.float64)
    mse = float(np.dot(diff, diff)) / a.size
    if mse == 0:
        return 99.0
    return 20.0 * math.log10(max_val) - 10.0 * math.log10(mse)


def psnr_from_stats(sum_sq_err: int, count: int, max_val: int) -> float:
    """PSNR from an exact integer Σerr² and the observed max.

    Bit-identical to `image_psnr` when the stats are exact: Σerr² for 8-bit
    frames is < 2^53, so the float64 division reproduces image_psnr.
    """
    mse = float(int(sum_sq_err)) / count
    if mse == 0:
        return 99.0
    return 20.0 * math.log10(int(max_val)) - 10.0 * math.log10(mse)


def compensate_frame_np(
    ref: np.ndarray, mv_y: np.ndarray, mv_x: np.ndarray, blk_dim: int
) -> np.ndarray:
    """Host-side motion compensation: comp[p] = ref[p + mv(block(p))].

    Exact for truncated edge blocks: valid full-search MVs keep every
    gather in-frame.
    """
    h, w = ref.shape
    mvy_px = np.repeat(np.repeat(mv_y, blk_dim, 0), blk_dim, 1)[:h, :w]
    mvx_px = np.repeat(np.repeat(mv_x, blk_dim, 0), blk_dim, 1)[:h, :w]
    yy = np.arange(h, dtype=np.int64)[:, None] + mvy_px
    xx = np.arange(w, dtype=np.int64)[None, :] + mvx_px
    return ref.astype(np.int32)[yy, xx]


def residual_mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared residual between two frames (float64, the true value)."""
    d = a.astype(np.float64).ravel() - b.astype(np.float64).ravel()
    return float(np.dot(d, d)) / d.size


def residual_mse_c_float32(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared residual with the reference's float32 accumulation.

    The SSIM driver accumulates the squared diffs sequentially in a float;
    reproduced with a sequential float32 accumulate for output parity.
    """
    d = a.astype(np.int64).ravel() - b.astype(np.int64).ravel()
    terms = (d * d).astype(np.float32)
    total = np.add.accumulate(terms, dtype=np.float32)[-1]
    return float(np.float32(total) / np.float32(d.size))


def stack_output(
    ref: np.ndarray, cur: np.ndarray, comp: np.ndarray
) -> np.ndarray:
    """The 5-frame stack [ref, cur, comp, |ref-cur|, |comp-cur|], [5*H, W]
    int32, built by the native library from three [H, W] frames."""
    return io_native.stack_output(ref, cur, comp)


def stack_output_np(
    ref: np.ndarray, cur: np.ndarray, comp: np.ndarray
) -> np.ndarray:
    """The plain version of `stack_output`."""
    return np.concatenate(
        (
            ref.astype(np.int32),
            cur.astype(np.int32),
            comp.astype(np.int32),
            frame_diff(ref, cur),
            frame_diff(comp, cur),
        ),
        axis=0,
    )


def output_filename(output_dir: str | os.PathLike, blk_dim: int, span: int) -> str:
    """``<dir>/output_<blk>_<span>.yuv``."""
    return os.path.join(os.fspath(output_dir), f"output_{blk_dim}_{span}.yuv")
