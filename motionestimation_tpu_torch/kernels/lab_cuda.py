"""The speed-of-light tools' kernels, on csrc/lab.cu.

The PyTorch counterparts of the Pallas kernels of the JAX repo's
`tools/vpu_peak.py` and `tools/kern_lab.py` (driven by the port's
`motionestimation_tpu_torch/tools/`):

* `lab_peak` launches `me_lab_peak` (P1), the port of `make_kernel`
  (vpu_peak.py:44): four accumulator streams per element under the fma,
  mix or roll instruction mix (roll: a row a CUDA block, neighbouring
  columns a thread, their halo recomputed, no barrier a step).
* `lab_chain` launches `me_lab_chain` (P2), the port of `run_chain`'s kernel
  (vpu_peak.py:99): the phase kernel's difference chain and dy minimum in
  isolation, one thread an element.
* `lab_phase` launches `me_lab_phase` (L2), the port of `make_phase_kernel`
  (kern_lab.py:357): exact SSD by the cross term, or SAD, with the
  lexicographic (cost, flat) minimum; float32 cost and int32 index.
* `lab_diff` launches `me_lab_diff` (L4), the port of `make_p4_kernel`
  (kern_lab.py:657): SSD by the diff form, or SAD, as the packed int32 key
  cost * 625 + flat - 2^31 (wrapping), INT32_MAX where invalid.
* `lab_padded` launches `me_lab_padded` (L1), the port of `make_kernel`
  (kern_lab.py:74): the unmasked search over the zero-padded reference,
  variants "NOP", "L0", "L1", "M1", "M2", "M3", each (macroblock, offset)
  cost summed in registers (no product scratch).
* `lab_p3` launches `me_lab_p3` (L3), the port of `make_p3_kernel`
  (kern_lab.py:504): L4's key by the cross term (Qcur + Qref) - 2X, or
  SAD, and the `nochain` / `nofold` ablations.
* `lab_p5`, `lab_p6`, `lab_p7` launch `me_lab_p5` (L5, `make_p5_kernel`
  :773: the diff form or SAD, float32 or bfloat16 planes), `me_lab_p6`
  (L6, `make_p6_kernel` :898: the cross term (Qcur - X) + (Qref - X)) and
  `me_lab_p7` (L7, `make_p7_kernel` :1044: the diff form over bfloat16
  planes), each L4's key.

L2-L7 run one kernel on the card (`lab_key_kernel`): L1's layout and
register ring over bytes, the candidates whose window leaves the frame
masked, in seven instances (`KEY_INSTANCES`). The diff form's key takes
"P4", "P5", "P5B", "P7"; SAD's key "P4S", "P5S", "P5SB", "P7S", "P3S";
the cross term's key "P3", "P6", "P6B"; the cross term's and SAD's
(cost, idx) "P0" and "P1"; "P3A" and "P3B" one instance each (bfloat16
holds 0..255 exactly, so the bfloat16 variants compute their float32
variants' function).

Beside each kernel stands its plain PyTorch version (`peak_plain`,
`chain_plain`, `phase_plain`, `diff_plain`, `padded_plain`, `raw_plain`,
`nop_plain`, `nochain_plain`, `nofold_plain`). The lab's masked search
kernels compute the exact full search over valid candidates with the
first-in-raster-order tie rule, so their plain versions are a thin layer
over the golden `search.full_search.full_search_frame`; L3's "P3", "P3S"
and L5-L7 give L4's key (bfloat16 holds 0..255 exactly), so `diff_plain`
is theirs too. A wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in `launches`.

Lab operands (every search above): cur float32 [H, W] of integer
pixels 0..255; ref_p float32, at least [H + 24, W + 24], reference pixel
(y, x) at [y + 12, x + 12] (the tool's zero-padded halo, [H + 24, 2176] at
2048x2048). Blocks 8x8, span 12. `tile_h` is the number of pixel rows a
CUDA block covers (the TPU stripe height): a positive multiple of 8
dividing H. Outputs are [H / 8, W / 8], one entry per block.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.search import full_search as fs

# The lab's geometry (tools/kern_lab.py): 8x8 blocks, span 12.
BLK = 8
SPAN = 12
K = 2 * SPAN + 1
BIG = 3.0e8         # L2's cost where no candidate is valid
KEY_BIAS = -(2**31)
I32_MAX = 2**31 - 1
# The chain's shape (tools/vpu_peak.py CH_BLK, CH_K) and its repetitions.
CHAIN_BLK = 8
CHAIN_K = 25
CHAIN_REPS = 64

MIXES = {"fma": 0, "mix": 1, "roll": 2}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "me_lab_peak": [_PTR] * 2 + [_INT] * 5 + [_PTR],
    "me_lab_chain": [_PTR] * 3 + [_INT] * 5 + [_PTR],
    "me_lab_phase": [_PTR] * 4 + [_INT] * 7 + [_PTR],
    "me_lab_diff": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    "me_lab_padded": [_PTR] * 4 + [_INT] * 7 + [_PTR],
    "me_lab_p3": [_PTR] * 3 + [_INT] * 8 + [_PTR],
    "me_lab_p5": [_PTR] * 3 + [_INT] * 8 + [_PTR],
    "me_lab_p6": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    "me_lab_p7": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    "me_lab_occupancy": [_INT] * 3 + [_PTR],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lab")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(wrapper, device, *args) -> None:
    """Call `wrapper`'s launcher (me_<wrapper name>) on the current stream
    of `device`, raise on a CUDA error, and count the launch."""
    fn = getattr(_lib(), f"me_{wrapper.__name__}")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")
    wrapper.launches += 1


def _check_cuda(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA or CPU tensors, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"operands need unit column stride, got "
                             f"strides {t.stride()}")


def _check_float_2d(**tensors) -> None:
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"operands on several devices: {devices}")
    for name, t in tensors.items():
        if t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be 2-D float32, got {t.dtype} "
                             f"{tuple(t.shape)}")


# -- P1 ----------------------------------------------------------------------

def _check_mix(mix: str) -> None:
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {sorted(MIXES)}, got {mix!r}")


def peak_plain(a: torch.Tensor, mix: str, *, inner: int,
               outer: int) -> torch.Tensor:
    """Plain version of P1: the four streams stacked in one [4, rows, cols]
    tensor, so a step is one or two torch ops. Multiply and add are
    separate ops here (the kernel fuses them with fmaf)."""
    _check_mix(mix)
    restart = a * torch.tensor([0.5, 0.25, 0.125], dtype=a.dtype,
                               device=a.device)[:, None, None]
    x = a
    for _ in range(outer):
        s = torch.cat([x[None], restart])
        if mix == "fma":
            for _ in range(inner // 4):
                s = a * s + 1.0
        elif mix == "mix":
            for _ in range(inner // 8):
                d = s - a
                s = d * d + s
        else:
            for _ in range(inner // 8):
                s = s + s.roll(-1, dims=2)  # s[c] + s[(c + 1) % cols]
        x = (s[0] + s[1]) + (s[2] + s[3])
    return x


def lab_peak(a: torch.Tensor, *, mix: str, inner: int,
             outer: int) -> torch.Tensor:
    """P1 on a float32 [rows, cols] plane (`me_lab_peak`). The roll mix
    covers a row with one CUDA block: cols a multiple of 32, at most
    1024."""
    _check_mix(mix)
    _check_float_2d(a=a)
    if a.device.type == "cpu":
        return peak_plain(a, mix, inner=inner, outer=outer)
    _check_cuda(a)
    rows, cols = a.shape
    if mix == "roll" and (cols % 32 or cols > 1024):
        raise ValueError(f"the roll mix needs cols a multiple of 32 and at "
                         f"most 1024, got {cols}")
    a = a.contiguous()
    out = torch.empty_like(a)
    _launch(lab_peak, a.device, a.data_ptr(), out.data_ptr(), rows, cols,
            inner, outer, MIXES[mix])
    return out


lab_peak.launches = 0


# -- P2 ----------------------------------------------------------------------

def _chain_shape(c, e, ch_g):
    _check_float_2d(c=c, e=e)
    n_phase = CHAIN_BLK + CHAIN_K - 1
    if (c.shape[0] != CHAIN_BLK * ch_g or e.shape[0] != n_phase * ch_g
            or c.shape[1] != e.shape[1]):
        raise ValueError(
            f"c must be [{CHAIN_BLK} * ch_g, w] and e [{n_phase} * ch_g, w] "
            f"with ch_g={ch_g}, got {tuple(c.shape)} and {tuple(e.shape)}")
    return c.shape[1]


def chain_plain(c: torch.Tensor, e: torch.Tensor, *, ch_g: int) -> torch.Tensor:
    """Plain version of P2: min over dy of sum_r (C_r - E_{dy+r})^2 on
    [ch_g, w] slabs. Every value is an integer below 2^24, so the order of
    the sum does not matter; the repetitions give the same result and run
    once."""
    w = _chain_shape(c, e, ch_g)
    cs = c.reshape(CHAIN_BLK, ch_g, w)
    es = e.reshape(CHAIN_BLK + CHAIN_K - 1, ch_g, w)
    windows = es.unfold(0, CHAIN_BLK, 1).permute(0, 3, 1, 2)  # [K, BLK, g, w]
    d = cs[None] - windows
    return (d * d).sum(1).amin(0)


def lab_chain(c: torch.Tensor, e: torch.Tensor, *, ch_g: int) -> torch.Tensor:
    """P2 (`me_lab_chain`): c float32 [8 * ch_g, w], e float32 [32 * ch_g,
    w]; returns float32 [ch_g, w]. The kernel repeats the work CHAIN_REPS
    times, as the TPU kernel's loop does."""
    w = _chain_shape(c, e, ch_g)
    if c.device.type == "cpu":
        return chain_plain(c, e, ch_g=ch_g)
    _check_cuda(c, e)
    c, e = c.contiguous(), e.contiguous()
    out = torch.empty((ch_g, w), dtype=torch.float32, device=c.device)
    _launch(lab_chain, c.device, c.data_ptr(), e.data_ptr(), out.data_ptr(),
            ch_g, w, CHAIN_BLK, CHAIN_K, CHAIN_REPS)
    return out


lab_chain.launches = 0


# -- L2, L4 --------------------------------------------------------------------

def _check_lab_operands(cur, ref_p, tile_h: int) -> None:
    """Raise unless cur and ref_p are 2-D float32 on one device, the halo
    covers the frame plus the span, and tile_h is a positive multiple of 8
    dividing the frame height."""
    _check_float_2d(cur=cur, ref_p=ref_p)
    h, w = cur.shape
    if ref_p.shape[0] < h + 2 * SPAN or ref_p.shape[1] < w + 2 * SPAN:
        raise ValueError(f"ref_p {tuple(ref_p.shape)} must cover "
                         f"({h + 2 * SPAN}, {w + 2 * SPAN})")
    if tile_h <= 0 or tile_h % BLK or h % tile_h or w % BLK:
        raise ValueError(f"tile_h must be a positive multiple of {BLK} "
                         f"dividing H, and W a multiple of {BLK}: tile_h "
                         f"{tile_h}, frame {h}x{w}")


def _golden(cur, ref_p, sad: bool) -> fs.MotionField:
    h, w = cur.shape
    ref = ref_p[SPAN : SPAN + h, SPAN : SPAN + w]
    for name, t in (("cur", cur), ("ref", ref)):
        if not bool(((t >= 0) & (t <= 255) & (t == t.round())).all()):
            raise ValueError(f"{name} must hold integer pixels 0..255")
    return fs.full_search_frame(cur.to(torch.int32), ref.to(torch.int32),
                                blk_dim=BLK, span=SPAN,
                                metric="sad" if sad else "mse")


def _flat(field: fs.MotionField) -> torch.Tensor:
    return ((field.mv_y + SPAN) * K + field.mv_x + SPAN).to(torch.int32)


def phase_plain(cur, ref_p, *, sad: bool = False):
    """Plain version of L2: the golden search's best cost as float32 and
    its flat index (mv_y + 12) * 25 + (mv_x + 12)."""
    field = _golden(cur, ref_p, sad)
    return field.best_cost_i32.to(torch.float32), _flat(field)


def diff_plain(cur, ref_p, *, sad: bool = False) -> torch.Tensor:
    """Plain version of L4: cost * 625 + flat - 2^31, packed in int64 (it
    lies in int32's range) and cast to int32."""
    field = _golden(cur, ref_p, sad)
    key = field.best_cost_i32.to(torch.int64) * (K * K) + _flat(field) + KEY_BIAS
    return key.to(torch.int32)


def lab_phase(cur, ref_p, *, tile_h: int, sad: bool = False):
    """L2 (`me_lab_phase`): (float32 cost, int32 flat index), [H/8, W/8]."""
    _check_lab_operands(cur, ref_p, tile_h)
    if cur.device.type == "cpu":
        return phase_plain(cur, ref_p, sad=sad)
    _check_cuda(cur, ref_p)
    h, w = cur.shape
    cost = torch.empty((h // BLK, w // BLK), dtype=torch.float32,
                       device=cur.device)
    idx = torch.empty((h // BLK, w // BLK), dtype=torch.int32,
                      device=cur.device)
    _launch(lab_phase, cur.device, cur.data_ptr(), ref_p.data_ptr(),
            cost.data_ptr(), idx.data_ptr(), cur.stride(0), ref_p.stride(0),
            w // BLK, h, w, tile_h, int(sad))
    return cost, idx


lab_phase.launches = 0


def lab_diff(cur, ref_p, *, tile_h: int, sad: bool = False) -> torch.Tensor:
    """L4 (`me_lab_diff`): the int32 packed key, [H/8, W/8]."""
    _check_lab_operands(cur, ref_p, tile_h)
    if cur.device.type == "cpu":
        return diff_plain(cur, ref_p, sad=sad)
    _check_cuda(cur, ref_p)
    h, w = cur.shape
    key = torch.empty((h // BLK, w // BLK), dtype=torch.int32,
                      device=cur.device)
    _launch(lab_diff, cur.device, cur.data_ptr(), ref_p.data_ptr(),
            key.data_ptr(), cur.stride(0), ref_p.stride(0), w // BLK, h, w,
            tile_h, int(sad))
    return key


lab_diff.launches = 0


# -- L1 ----------------------------------------------------------------------

# L1's variants (tools/kern_lab.py `make_kernel`), by launcher code.
PADDED_VARIANTS = {"NOP": 0, "L0": 1, "L1": 2, "M1": 3, "M2": 4, "M3": 5}
START_IDX = SPAN * K + SPAN  # L1's start pair is (BIG, START_IDX)


def check_padded_variant(variant: str) -> None:
    if variant not in PADDED_VARIANTS:
        raise ValueError(variant)  # as the JAX tool's make_kernel raises


def _frame_window(cur, ref_p):
    """ref_p cut to [H + 24, W + 24], as float64."""
    h, w = cur.shape
    return ref_p[: h + 2 * SPAN, : w + 2 * SPAN].double()


def _block_sums(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8, W/8]: the sum of each 8x8 block."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // BLK, BLK, w // BLK, BLK).sum((-3, -1))


def _box_squares(ref: torch.Tensor) -> torch.Tensor:
    """S[y, x] = sum over the 8x8 box at (y, x) of ref^2: [h - 7, w - 7]."""
    sq = ref * ref
    col = sq.unfold(0, BLK, 1).sum(-1)
    return col.unfold(1, BLK, 1).sum(-1)


def _qref(s: torch.Tensor, oy: int, nby: int, nbx: int) -> torch.Tensor:
    """[K, nby, nbx]: Qref at offset row oy and each offset column ox of
    every block, from the box-sum plane of the window."""
    rows = s[oy : oy + BLK * nby : BLK]                    # [nby, w - 7]
    cols = (torch.arange(K, device=s.device)[:, None]
            + BLK * torch.arange(nbx, device=s.device)[None])  # [K, nbx]
    return rows[:, cols].permute(1, 0, 2)


def _lexmin(costs):
    """(float32 cost, int32 flat) of the first minimum over candidates in
    raster order; `costs` yields [K, nby, nbx] float64 integer costs per
    offset row. cost * 625 + flat (exact in float64) orders candidates as
    (cost, flat) does, so its least value is the first minimum."""
    best = None
    for oy, c in enumerate(costs):
        flat = oy * K + torch.arange(K, dtype=c.dtype, device=c.device)
        key = (c * (K * K) + flat[:, None, None]).amin(0)
        best = key if best is None else torch.minimum(best, key)
    cost = torch.div(best, K * K, rounding_mode="floor")
    return cost.to(torch.float32), (best - cost * (K * K)).to(torch.int32)


def padded_plain(cur, ref_p, *, sad: bool = False, rounding: bool = False):
    """Plain version of L1's "L0", "M1" (sad False), "M2" (sad True) and
    "M3" (rounding True): the first minimum in raster order over all 625
    offsets of the zero-padded reference, unmasked, so out-of-frame
    pixels count as 0. SSD is (Qcur - X) + (Qref - X); with `rounding`
    each product of X is first rounded to bfloat16 (to nearest even).
    Returns (float32 cost, int32 flat index), [H/8, W/8]."""
    h, w = cur.shape
    c = cur.double()
    win = _frame_window(cur, ref_p)
    nby, nbx = h // BLK, w // BLK
    if not sad:
        qcur = _block_sums(c * c)
        s = _box_squares(win)

    def costs():
        for oy in range(K):
            e = win[oy : oy + h].unfold(1, w, 1).permute(1, 0, 2)  # [K, h, w]
            if sad:
                yield _block_sums((c - e).abs())
                continue
            prod = c * e
            if rounding:
                prod = prod.float().to(torch.bfloat16).double()
            x = _block_sums(prod)
            yield (qcur - x) + (_qref(s, oy, nby, nbx) - x)

    return _lexmin(costs())


def raw_plain(cur, ref_p, *, tile_h: int):
    """Plain version of L1's "L1" ablation: no block sum, no slide. Block
    row Rg in stripe Rg // (tile_h / 8) takes X at pixel row
    y0 + Rg % (tile_h / 8) (the stripe's row R, not 8R) and the block's
    first column: X = cur[y0 + R, c] * ref_p[y0 + R + oy, c + ox]; cost
    (Qcur - X) + (Qref - X), first minimum over all 625 offsets."""
    h, w = cur.shape
    nby, nbx = h // BLK, w // BLK
    c = cur.double()
    win = _frame_window(cur, ref_p)
    g = tile_h // BLK
    rg = torch.arange(nby, device=cur.device)
    py = rg // g * tile_h + rg % g                            # [nby]
    bx = BLK * torch.arange(nbx, device=cur.device)
    cols = torch.arange(K, device=cur.device)[:, None] + bx[None]  # [K, nbx]
    qcur = _block_sums(c * c)
    s = _box_squares(win)
    cv = c[py][:, bx]                                         # [nby, nbx]

    def costs():
        for oy in range(K):
            x = cv[None] * win[py + oy][:, cols].permute(1, 0, 2)
            yield (qcur - x) + (_qref(s, oy, nby, nbx) - x)

    return _lexmin(costs())


def nop_plain(cur, ref_p):
    """Plain version of L1's "NOP": the start pair (3e8, 312) per block."""
    h, w = cur.shape
    shape = (h // BLK, w // BLK)
    return (torch.full(shape, BIG, dtype=torch.float32, device=cur.device),
            torch.full(shape, START_IDX, dtype=torch.int32,
                       device=cur.device))


def lab_padded(cur, ref_p, *, tile_h: int, variant: str):
    """L1 (`me_lab_padded`): (float32 cost, int32 flat index), [H/8, W/8],
    for variant "NOP", "L0", "L1", "M1", "M2" or "M3"."""
    check_padded_variant(variant)
    _check_lab_operands(cur, ref_p, tile_h)
    if cur.device.type == "cpu":
        if variant == "NOP":
            return nop_plain(cur, ref_p)
        if variant == "L1":
            return raw_plain(cur, ref_p, tile_h=tile_h)
        return padded_plain(cur, ref_p, sad=variant == "M2",
                            rounding=variant == "M3")
    _check_cuda(cur, ref_p)
    h, w = cur.shape
    cost = torch.empty((h // BLK, w // BLK), dtype=torch.float32,
                       device=cur.device)
    idx = torch.empty((h // BLK, w // BLK), dtype=torch.int32,
                      device=cur.device)
    _launch(lab_padded, cur.device, cur.data_ptr(), ref_p.data_ptr(),
            cost.data_ptr(), idx.data_ptr(), cur.stride(0), ref_p.stride(0),
            w // BLK, h, w, tile_h, PADDED_VARIANTS[variant])
    return cost, idx


lab_padded.launches = 0


# The roll mix's instances, by columns a thread: 8, or 16 where a launch
# has at least two rows an SM.
ROLL_INSTANCES = {"roll 8": 6, "roll 16": 7}
# The key kernel's instances (L2-L7): L4's key by the diff form ("P4",
# "P5", "P5B", "P7"), by SAD ("P4S", "P5S", "P5SB", "P7S", "P3S") and by the
# cross term ("P3", "P6", "P6B"); L2's (cost, idx) by the cross term ("P0")
# and by SAD ("P1"); L3's ablations "P3A" (nochain) and "P3B" (nofold).
KEY_INSTANCES = {"key ssd": 8, "key sad": 9, "key cross": 10,
                 "pair cross": 11, "pair sad": 12, "key nochain": 13,
                 "key nofold": 14}
# P2's kernel.
CHAIN_INSTANCES = {"chain": 15}


def lab_occupancy(kernel: str, *, cols: int = 1024,
                  inner: int = 64) -> dict:
    """The resources on the current card of the instance that `lab_padded`
    launches for variant `kernel` ("NOP", "L0", "L1", "M1", "M2", "M3"), of
    the key kernel's instance `kernel` (a `KEY_INSTANCES` name), of the
    roll mix's instance `kernel` ("roll 8", "roll 16") on rows of
    `cols` columns at `inner`, or of P2's kernel ("chain"): registers and
    local (spill) bytes per thread, threads and dynamic shared bytes per
    CUDA block, CUDA blocks and warps resident per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`). Needs a card."""
    codes = {**PADDED_VARIANTS, **ROLL_INSTANCES, **KEY_INSTANCES,
             **CHAIN_INSTANCES}
    if kernel not in codes:
        check_padded_variant(kernel)
    code = codes[kernel]
    out = (ctypes.c_int * 5)()
    err = _lib().me_lab_occupancy(code, cols, inner, out)
    if err != 0:
        raise RuntimeError(f"me_lab_occupancy failed with CUDA error {err}")
    regs, local, threads, smem, blocks = out
    return dict(registers=regs, local_bytes=local, threads=threads,
                smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * -(-threads // 32))


# -- L3, L5, L6, L7 ------------------------------------------------------------

ABLATIONS = {None: 0, "nochain": 1, "nofold": 2}


def nochain_plain(cur, ref_p) -> torch.Tensor:
    """Plain version of L3's "P3A" (`nochain`), as the port defines it. The
    TPU kernel writes only the dy = 0 rows of its chain buffer with the
    first term C_0 * E_0 and reads the other 24 dy groups unwritten; here
    they are 0. So for offset row oy = 0, X = sum_{k<8} cur[8Rg, c + k] *
    ref_p[8Rg, c + ox + k] (the block's first row against reference row
    8Rg - 12), and X = 0 for oy >= 1; cost (Qcur + Qref) - 2X, packed as
    L4's key over L4's valid candidates: u = (cost * 625 + flat) mod 2^32,
    the least u (2^32 - 1 where no candidate is valid), key = u - 2^31."""
    h, w = cur.shape
    nby, nbx = h // BLK, w // BLK
    c = cur.double()
    win = _frame_window(cur, ref_p)
    qcur = _block_sums(c * c)
    s = _box_squares(win)
    dev = cur.device
    ty = BLK * torch.arange(nby, device=dev)
    tx = BLK * torch.arange(nbx, device=dev)
    row = win[ty].unfold(1, BLK, 1)                 # [nby, w + 17, 8]
    crow = c[ty].reshape(nby, nbx, BLK)             # each block's first row
    cols = torch.arange(K, device=dev)[:, None] + tx[None]    # [K, nbx]
    x0 = (crow[:, None] * row[:, cols]).sum(-1).permute(1, 0, 2)  # [K, nby, nbx]
    best = torch.full((nby, nbx), 2**32 - 1, dtype=torch.int64, device=dev)
    ok_x = (cols - SPAN >= 0) & (cols - SPAN <= w - BLK)     # [K, nbx]
    for oy in range(K):
        x = x0 if oy == 0 else torch.zeros_like(x0)
        cost = (qcur + _qref(s, oy, nby, nbx)) - 2 * x
        flat = oy * K + torch.arange(K, device=dev)[:, None, None]
        u = (cost.long() * (K * K) + flat) % 2**32
        ok_y = ((ty + oy - SPAN >= 0) & (ty + oy - SPAN <= h - BLK))
        u = torch.where(ok_y[None, :, None] & ok_x[:, None, :], u, 2**32 - 1)
        best = torch.minimum(best, u.amin(0))
    return (best + KEY_BIAS).to(torch.int32)


def nofold_plain(cur, ref_p) -> torch.Tensor:
    """Plain version of L3's "P3B" (`nofold`): per block, the least over
    ox of int32(sum_{r<8} cur[8Rg + r, c] * ref_p[8Rg + r, c + ox]), the
    dy = 0 group's chain at the block's first column, with no slide, no
    key and no mask."""
    h, w = cur.shape
    nby, nbx = h // BLK, w // BLK
    tx = BLK * torch.arange(nbx, device=cur.device)
    cols = torch.arange(K, device=cur.device)[:, None] + tx[None]  # [K, nbx]
    e = ref_p[:h].double()[:, cols]                          # [h, K, nbx]
    prod = cur.double()[:, tx][:, None] * e
    chain = prod.reshape(nby, BLK, K, nbx).sum(1)            # [nby, K, nbx]
    return chain.amin(1).to(torch.int32)


def _key_wrapper(wrapper, plain, cur, ref_p, tile_h, *flags):
    """Shared body of the key-form wrappers: the plain version on the CPU,
    else one launch of `wrapper`'s kernel with `flags` (ints)."""
    _check_lab_operands(cur, ref_p, tile_h)
    if cur.device.type == "cpu":
        return plain()
    _check_cuda(cur, ref_p)
    h, w = cur.shape
    key = torch.empty((h // BLK, w // BLK), dtype=torch.int32,
                      device=cur.device)
    _launch(wrapper, cur.device, cur.data_ptr(), ref_p.data_ptr(),
            key.data_ptr(), cur.stride(0), ref_p.stride(0), w // BLK, h, w,
            tile_h, *flags)
    return key


def lab_p3(cur, ref_p, *, tile_h: int, sad: bool = False,
           ablate: str | None = None) -> torch.Tensor:
    """L3 (`me_lab_p3`): "P3" (SSD by the cross term (Qcur + Qref) - 2X)
    and "P3S" (SAD) give L4's key; `ablate` "nochain" ("P3A") and
    "nofold" ("P3B") give the ablations of `nochain_plain` and
    `nofold_plain` (SSD only)."""
    if ablate not in ABLATIONS or (sad and ablate):
        raise ValueError(f"ablate must be None, 'nochain' or 'nofold' (SSD "
                         f"only), got {ablate!r} with sad={sad}")

    def plain():
        if ablate == "nochain":
            return nochain_plain(cur, ref_p)
        if ablate == "nofold":
            return nofold_plain(cur, ref_p)
        return diff_plain(cur, ref_p, sad=sad)

    return _key_wrapper(lab_p3, plain, cur, ref_p, tile_h, int(sad),
                        ABLATIONS[ablate])


lab_p3.launches = 0


def lab_p5(cur, ref_p, *, tile_h: int, sad: bool = False,
           bf16: bool = False) -> torch.Tensor:
    """L5 (`me_lab_p5`): the diff form ("P5"), or SAD ("P5S"), over float32
    or (`bf16`: "P5B", "P5SB") bfloat16 planes; L4's key."""
    return _key_wrapper(lab_p5, lambda: diff_plain(cur, ref_p, sad=sad), cur,
                        ref_p, tile_h, int(sad), int(bf16))


lab_p5.launches = 0


def lab_p6(cur, ref_p, *, tile_h: int, bf16: bool = False) -> torch.Tensor:
    """L6 (`me_lab_p6`): SSD by the cross term (Qcur - X) + (Qref - X),
    over float32 or (`bf16`: "P6B") bfloat16 planes; L4's key."""
    return _key_wrapper(lab_p6, lambda: diff_plain(cur, ref_p), cur, ref_p,
                        tile_h, int(bf16))


lab_p6.launches = 0


def lab_p7(cur, ref_p, *, tile_h: int, sad: bool = False) -> torch.Tensor:
    """L7 (`me_lab_p7`): the diff form ("P7"), or SAD ("P7S"), over
    bfloat16 planes; L4's key."""
    return _key_wrapper(lab_p7, lambda: diff_plain(cur, ref_p, sad=sad), cur,
                        ref_p, tile_h, int(sad))


lab_p7.launches = 0
