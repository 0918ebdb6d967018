"""`tools/multicard_gop.py` on the CPU: its dump comparison and its refusal
to run without a card a rank (the timings themselves need the cards)."""
import numpy as np
import pytest
import torch

from motionestimation_tpu_torch.tools import multicard_gop


def _dumps(path, values):
    path.mkdir()
    for i, v in enumerate(values):
        np.savez(path / f"mv_{i:05d}.npz", mv_y=np.full((2, 3), v, np.int32),
                 psnr=np.float64(v))


def test_same_dumps_counts_equal_dumps_and_raises_on_a_difference(tmp_path):
    _dumps(tmp_path / "want", [1, 2])
    _dumps(tmp_path / "same", [1, 2])
    _dumps(tmp_path / "other", [1, 3])
    assert multicard_gop.same_dumps(str(tmp_path / "same"),
                                    str(tmp_path / "want")) == 2
    with pytest.raises(AssertionError, match="mv_00001.npz differs"):
        multicard_gop.same_dumps(str(tmp_path / "other"),
                                 str(tmp_path / "want"))
    (tmp_path / "same" / "mv_00001.npz").unlink()
    with pytest.raises(AssertionError, match="dumps differ"):
        multicard_gop.same_dumps(str(tmp_path / "same"),
                                 str(tmp_path / "want"))


def test_needs_a_card_a_rank(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 4 cards"):
        multicard_gop.main(["--frames", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # no frame written
