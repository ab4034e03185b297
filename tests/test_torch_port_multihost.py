"""Two processes of the port's data-parallel step over gloo on the CPU
(the port of tests/test_multihost_process.py): each takes half of one
global batch; both end with the same parameters bit for bit, and with a
one-process ``data_parallel: 2`` step's to 1e-6. The run has its own
timeout of 120 s."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from sgnn_tpu_torch.parallel import multihost

WORKER = Path(__file__).parent / "_torch_multihost_worker.py"
TIMEOUT_S = 120.0
REF_TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def two_process_check(tmp_path, device="cpu"):
    """Two workers (a group of 2) and the one-process reference; both
    workers end bit-equal, and within REF_TOL of the reference."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    runs = [(2, r, tmp_path / f"rank{r}.npz") for r in range(2)] + [(1, 0, tmp_path / "ref.npz")]
    procs = [subprocess.Popen([sys.executable, str(WORKER), "--port", str(port), "--rank", str(r),
                               "--nprocs", str(n), "--out", str(out), "--device", device],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for n, r, out in runs]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    rank0, rank1, ref = (np.load(out) for _, _, out in runs)
    assert np.array_equal(rank0["params"], rank1["params"]) and rank0["loss"] == rank1["loss"]
    np.testing.assert_allclose(rank0["params"], ref["params"], rtol=REF_TOL, atol=REF_TOL)
    np.testing.assert_allclose(rank0["loss"], ref["loss"], rtol=REF_TOL)


def test_two_process_dp_step_matches_one_process(tmp_path):
    two_process_check(tmp_path)


def test_single_process_helpers(monkeypatch):
    """Without a group: initialize is a no-op, one process owns all."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    multihost.initialize()
    assert not multihost.distributed() and multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.host_seed(7) == 7 * 1_000_003
    assert multihost.host_batch_slice(16) == 16
    x = np.arange(4.0)
    assert multihost.all_gather_sum(x) is x
