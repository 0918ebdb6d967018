"""The port's sharded path across processes (tests/torch_multihost_worker.py):
a (1, 2 * world, 2) mesh whose "ty" axis spans the ranks, so the halo
crosses the process boundaries; each rank feeds only its own frame rows,
and its results must equal the unsharded port path. Two processes on
gloo here (the port's counterpart of tests/test_multihost.py); on a
machine with several cards, the `_cuda` cases run 2 and 4 ranks on NCCL,
one card each."""
import os
import socket
import subprocess
import sys

import pytest
import torch

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_multihost_worker.py")
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, world, extra=(), timeout=TIMEOUT_S):
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(rank), str(world), port,
             str(tmp_path), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"TORCH_MULTIHOST_OK rank={rank}" in out, out


def test_two_process_gloo_sharded_step(tmp_path):
    _run_workers(tmp_path, 2)


@pytest.mark.parametrize("world", [2, 4])
def test_nccl_sharded_step_cuda(tmp_path, world):
    """One rank a card, NCCL between them (the halo's sends and receives,
    the results' broadcasts, the stats' all_reduce)."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards, one a rank (NCCL)")
    _run_workers(tmp_path, world, ["cuda"], timeout=180)
