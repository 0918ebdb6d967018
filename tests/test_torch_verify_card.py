"""`tools/verify_card` with device="cpu" (the kernels' plain versions):
every committed fixture passes; a copy of a fixture with one byte of its
`output.yuv` changed fails, and `main` then exits 1."""
import os
import shutil

import torch

from motionestimation_tpu_torch.tools import verify_card

torch.set_num_threads(1)


def test_every_fixture_passes_on_cpu(capsys):
    results = verify_card.verify(device="cpu")
    names = sorted(d for d in os.listdir(verify_card.FIXTURES)
                   if os.path.exists(os.path.join(verify_card.FIXTURES, d,
                                                  "meta.json")))
    assert sorted(results) == names and len(names) == 13
    assert not any(results.values()), results
    assert "13/13 fixture cases exact on cpu" in capsys.readouterr().out


def test_a_changed_byte_fails(tmp_path, capsys):
    case = "rand_mse_52x36_8_12"
    shutil.copytree(os.path.join(verify_card.FIXTURES, case), tmp_path / case)
    stack = tmp_path / case / "output.yuv"
    data = bytearray(stack.read_bytes())
    data[2 * 36 * 52 + 100] ^= 1  # a pixel of the compensated plane
    stack.write_bytes(bytes(data))
    results = verify_card.verify(str(tmp_path), device="cpu")
    assert results == {case: ["stacked output differs from the fixture's "
                              "output.yuv"]}
    assert verify_card.main(["--device", "cpu", "--fixtures",
                             str(tmp_path)]) == 1
    assert "FAIL rand_mse_52x36_8_12" in capsys.readouterr().out
