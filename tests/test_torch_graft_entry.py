"""The port's `graft_entry` on the CPU: `entry(device="cpu")` against the
JAX package's `__graft_entry__.entry()` on the same arrays (MVs, int32
costs and compensated frame equal exactly), and `dryrun_multichip` on
meshes of CPU slots, which raises on the first difference from the
unsharded port. JAX's own dry run is not called here: it sets XLA_FLAGS.
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from motionestimation_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_entry_matches_jax_entry():
    step, (cur, ref) = graft_entry.entry(device="cpu")
    jstep, (jcur, jref) = jax_graft.entry()
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
    got = step(cur, ref)
    want = jstep(jcur, jref)
    for name, a, b in zip(("mv_y", "mv_x", "cost", "comp"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    assert got[3].shape == (288, 352)


@pytest.mark.parametrize("n,mesh", [(4, "dp=1 ty=2 tx=2"),
                                    (8, "dp=2 ty=2 tx=2")])
def test_dryrun_multichip_on_cpu_slots(n, mesh):
    summary = graft_entry.dryrun_multichip(n, device="cpu")
    assert summary.startswith(f"dryrun_multichip OK: mesh {mesh}")
    assert graft_entry._factor_mesh(n) == jax_graft._factor_mesh(n)


def test_around_sharded_holds_the_sharded_steps_alone(monkeypatch):
    """The window of `around_sharded` sees the three sharded steps and none
    of the unsharded runs they are held against."""
    calls, inside = [], [False]

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, inside[0]))
            return fn(*a, **kw)
        monkeypatch.setattr(graft_entry, name, wrapped)

    spy("sharded_motion_step", graft_entry.sharded_motion_step)
    spy("full_search_frame_cuda", graft_entry.full_search_frame_cuda)
    spy("ssim_search_frame_cuda", graft_entry.ssim_search_frame_cuda)

    class Window:
        def __enter__(self):
            inside[0] = True

        def __exit__(self, *exc):
            inside[0] = False

    graft_entry.dryrun_multichip(2, device="cpu", around_sharded=Window())
    assert [c for c in calls if c[1]] == [("sharded_motion_step", True)] * 3
    assert {c[0] for c in calls if not c[1]} == {
        "full_search_frame_cuda", "ssim_search_frame_cuda"}


def test_dryrun_raises_on_a_difference(monkeypatch):
    real = graft_entry.diamond.diamond_search_frame

    def off_by_one(*a, **kw):
        field = real(*a, **kw)
        return field._replace(best_cost_i32=field.best_cost_i32 + 1)

    monkeypatch.setattr(graft_entry.diamond, "diamond_search_frame",
                        off_by_one)
    with pytest.raises(RuntimeError, match="sharded diamond costs"):
        graft_entry.dryrun_multichip(2, device="cpu")


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4)
