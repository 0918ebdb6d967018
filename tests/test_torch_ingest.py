"""The port's sharded GOP (`pipeline/runner.run_gop_sharded`) and ingest
(`parallel/ingest.py`, `core/frames.load_yuv_rows`, held against the JAX
function) on the CPU.

`run_gop_sharded` on meshes of CPU slots must write the port's `run_gop`
dumps key for key, value for value and dtype for dtype (`score` included:
the JAX sharded path writes the integer cost there, ROADMAP Queue 3
reference fault 5), pipelined or per pair, with "dp" batching, after a
resume and with a hole. `escape_policy="crossover"` raises, where the JAX
path runs canonical diamond without a word (reference fault 2). Frames
are written to `tmp_path` from numpy seeds.
"""
import os

import numpy as np
import pytest
import torch

from motionestimation_tpu.core import frames as jax_frames
from motionestimation_tpu.core.config import SearchConfig as JaxSearchConfig
from motionestimation_tpu.parallel import make_mesh as jax_make_mesh
from motionestimation_tpu.pipeline import runner as jax_runner
from motionestimation_tpu_torch.core import frames
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.parallel import ingest, make_mesh
from motionestimation_tpu_torch.parallel import sharded
from motionestimation_tpu_torch.pipeline import runner

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(dp, ty, tx):
    return make_mesh(dp, ty, tx, devices=[CPU] * (dp * ty * tx))


def _gop(tmp_path, n, h, w, seed=77, prefix="f"):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    while len(out) < n:
        out.append(np.clip(np.roll(out[-1], (1, -2), (0, 1)).astype(np.int32)
                           + rng.integers(-3, 4, (h, w)), 0, 255)
                   .astype(np.uint8))
    paths = []
    for i, f in enumerate(out):
        paths.append(str(tmp_path / f"{prefix}{i}.yuv"))
        f.tofile(paths[-1])
    return paths


def _assert_same_dumps(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for key in zb.files:
            assert za[key].dtype == zb[key].dtype, (a, key)
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


CONFIGS = [
    dict(blk_dim=8, span=4),                        # packed in run_gop
    dict(blk_dim=8, span=5, metric="sad"),
    dict(blk_dim=8, span=4, metric="ssim"),
    dict(blk_dim=16, span=7, algorithm="diamond"),
    dict(blk_dim=8, span=3, algorithm="diamond", early_term=4.0),
]
MESHES = [((1, 2, 2), True), ((1, 2, 2), False), ((2, 1, 1), "auto"),
          ((2, 2, 2), "auto")]


@pytest.mark.parametrize("mesh_shape,pipelined", MESHES)
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_run_gop_sharded_equals_run_gop(tmp_path, kw, mesh_shape, pipelined):
    h, w = 52, 60  # truncated bottom and right block rows at blk 8 and 16
    paths = _gop(tmp_path, 5, h, w)
    config = SearchConfig(frame_width=w, frame_height=h, **kw)
    want = runner.run_gop(paths, config, device="cpu",
                          output_dir=tmp_path / "single")
    if pipelined is True and config.algorithm != "full":
        with pytest.raises(ValueError, match="pipelined=True"):
            runner.run_gop_sharded(paths, config, mesh=_mesh(*mesh_shape),
                                   output_dir=tmp_path / "sharded",
                                   pipelined=True)
        return
    got = runner.run_gop_sharded(paths, config, mesh=_mesh(*mesh_shape),
                                 output_dir=tmp_path / "sharded",
                                 pipelined=pipelined, chunk_pairs=3)
    _assert_same_dumps(got, want)


def test_run_gop_sharded_resume_and_hole(tmp_path):
    h, w = 48, 64
    paths = _gop(tmp_path, 6, h, w, seed=7)
    config = SearchConfig(blk_dim=8, span=4, frame_width=w, frame_height=h)
    mesh = _mesh(1, 2, 2)
    out_dir = tmp_path / "out"
    out = runner.run_gop_sharded(paths, config, mesh=mesh,
                                 output_dir=out_dir, chunk_pairs=2)
    golden = {p: dict(np.load(p)) for p in out}
    mtimes = {p: os.stat(p).st_mtime_ns for p in out}
    runner.run_gop_sharded(paths, config, mesh=mesh, output_dir=out_dir)
    assert {p: os.stat(p).st_mtime_ns for p in out} == mtimes
    os.remove(out[2])
    del mtimes[out[2]]
    for pipelined in (True, False):
        runner.run_gop_sharded(paths, config, mesh=mesh, output_dir=out_dir,
                               pipelined=pipelined)
        assert all(os.stat(p).st_mtime_ns == t for p, t in mtimes.items())
        got = np.load(out[2])
        assert sorted(got.files) == sorted(golden[out[2]])
        for key, value in golden[out[2]].items():
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)
        os.remove(out[2])


def test_run_gop_sharded_against_jax(tmp_path):
    """The JAX sharded dumps on the same GOP: equal MVs, best_cost and
    psnr; its `score` is the integer cost (reference fault 5) where the
    port's is run_gop's float32 cost / area."""
    h, w = 48, 64
    paths = _gop(tmp_path, 3, h, w, seed=3)
    kw = dict(blk_dim=8, span=4, frame_width=w, frame_height=h)
    got = runner.run_gop_sharded(paths, SearchConfig(**kw),
                                 mesh=_mesh(1, 2, 2),
                                 output_dir=tmp_path / "port")
    jgot = jax_runner.run_gop_sharded(paths, JaxSearchConfig(**kw),
                                      mesh=jax_make_mesh(1, 2, 2),
                                      output_dir=tmp_path / "jax")
    for a, b in zip(got, jgot):
        za, zb = np.load(a), np.load(b)
        for key in ("mv_y", "mv_x", "best_cost", "psnr", "cur", "ref"):
            np.testing.assert_array_equal(za[key], zb[key])
        np.testing.assert_array_equal(zb["score"], zb["best_cost"])
        assert zb["score"].dtype.kind == "i"
        assert za["score"].dtype == np.float32
        np.testing.assert_array_equal(
            za["score"], za["best_cost"].astype(np.float32) / 64)


def test_crossover_raises_where_jax_runs_canonical(tmp_path):
    """Reference fault 2: the JAX sharded GOP drops escape_policy and runs
    canonical diamond; the port refuses the policy."""
    h, w = 48, 64
    paths = _gop(tmp_path, 3, h, w, seed=5)
    kw = dict(blk_dim=8, span=4, frame_width=w, frame_height=h,
              algorithm="diamond")
    config = SearchConfig(escape_policy="crossover", **kw)
    with pytest.raises(ValueError, match="escape_policy='crossover'"):
        runner.run_gop_sharded(paths, config, mesh=_mesh(1, 2, 2),
                               output_dir=tmp_path / "port")
    assert not (tmp_path / "port").exists()
    jax_cross = jax_runner.run_gop_sharded(
        paths, JaxSearchConfig(escape_policy="crossover", **kw),
        mesh=jax_make_mesh(1, 2, 2), output_dir=tmp_path / "jax_cross")
    canonical = runner.run_gop_sharded(paths, SearchConfig(**kw),
                                       mesh=_mesh(1, 2, 2),
                                       output_dir=tmp_path / "canonical")
    for a, b in zip(jax_cross, canonical):
        za, zb = np.load(a), np.load(b)
        for key in ("mv_y", "mv_x", "best_cost"):
            np.testing.assert_array_equal(za[key], zb[key])


def test_load_yuv_rows(tmp_path):
    rng = np.random.default_rng(1)
    h, w = 30, 17
    path = str(tmp_path / "f.yuv")
    rng.integers(0, 256, (h, w), dtype=np.uint8).tofile(path)
    whole = frames.load_yuv(path, h, w)
    for lo, hi in ((0, h), (7, 19), (29, 30), (12, 12)):
        rows = frames.load_yuv_rows(path, h, w, lo, hi)
        assert rows.dtype == np.uint8 and rows.shape == (hi - lo, w)
        np.testing.assert_array_equal(rows, whole[lo:hi])
        np.testing.assert_array_equal(
            rows, jax_frames.load_yuv_rows(path, h, w, lo, hi))
    with pytest.raises(ValueError, match="outside"):
        frames.load_yuv_rows(path, h, w, 5, 31)
    with pytest.raises(IOError, match="expected"):
        frames.load_yuv_rows(path, h + 2, w, 20, 32)


def test_put_frame_batch_and_prefetcher():
    rng = np.random.default_rng(2)
    mesh = _mesh(2, 2, 2)
    batch = rng.integers(0, 256, (4, 32, 48), dtype=np.uint8)
    shards = ingest.put_frame_batch(batch, mesh)
    assert shards.shape == (4, 32, 48) and sorted(shards.tiles) == mesh.slots()
    for (d, iy, ix), t in shards.tiles.items():
        np.testing.assert_array_equal(
            t.numpy(), batch[2 * d : 2 * d + 2, 16 * iy : 16 * iy + 16,
                             24 * ix : 24 * ix + 24])
    assert ingest.local_row_range(mesh, 128) == (0, 128)
    batches = [rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
               for _ in range(5)]
    out = list(ingest.ShardedPrefetcher(iter(batches), mesh))
    assert len(out) == 5
    for host, staged in zip(batches, out):
        want = ingest.put_frame_batch(host, mesh)
        assert all(torch.equal(staged.tiles[s], want.tiles[s])
                   for s in mesh.slots())
    with pytest.raises(ValueError, match="does not split"):
        ingest.put_frame_batch(batch[:3], mesh)
    with pytest.raises(ValueError, match="0, 255"):
        ingest.put_frame_batch(batch.astype(np.int32) + 1, mesh)


def test_presharded_input_matches_host_input():
    """tests/test_ingest.py:25: frame shards from put_frame_batch give the
    same step as host arrays."""
    rng = np.random.default_rng(0)
    mesh = _mesh(2, 2, 2)
    refs = rng.integers(0, 256, (2, 64, 64), dtype=np.uint8)
    curs = np.clip(refs.astype(np.int32) + rng.integers(-6, 7, refs.shape),
                   0, 255).astype(np.uint8)
    kw = dict(mesh=mesh, blk_dim=8, span=4, frame_height=64, frame_width=64)
    a = sharded.gather(sharded.sharded_motion_step(curs, refs, **kw))
    b = sharded.gather(sharded.sharded_motion_step(
        ingest.put_frame_batch(curs, mesh), ingest.put_frame_batch(refs, mesh),
        **kw))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_distributed_init_needs_a_group_size():
    ingest.distributed_init()  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        ingest.distributed_init(num_processes=2)
