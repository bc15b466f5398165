"""Execute the multi-process runtime (parallel/multihost.py) for real:
two OS processes, each a JAX controller with 2 virtual CPU devices, form
a 4-device pod mesh, run a cross-process psum and a GSPMD BFV
keygen/encrypt/decrypt over an 'rns' axis spanning both processes
(tests/multihost_worker.py).  SURVEY.md §2.2's distributed backend."""

import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_pod_mesh_psum_and_keygen():
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(WORKER.parent.parent))
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"proc {pid}: multihost smoke OK" in out
