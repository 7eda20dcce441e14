"""Multi-host execution test: 2 real OS processes, localhost coordinator.

Drives parallel/multihost.py end-to-end without a cluster: each spawned
process runs multi-controller JAX on 2 virtual CPU devices (4 global devices,
2 processes), renders through render_multihost, and runs a cross-host
gradient-psum step (SURVEY.md §2 parallelism table row 3). Process 0 asserts
the assembled image equals a single-process render and the reduced gradients
match unsharded gradients (checks inside multihost_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_and_grad_psum():
    port = _free_port()
    nproc = 2
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # a clean XLA_FLAGS: the worker sets its own device count
    env["XLA_FLAGS"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(i), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    assert "MULTIHOST_OK" in outs[0], outs[0]
