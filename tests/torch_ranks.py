"""Run one command as N processes of a process group on the CPU (gloo):
each process gets ``JL_COORDINATOR`` (a free local port),
``JL_NUM_PROCESSES``, ``JL_PROCESS_ID`` and one thread, and the group a
deadline of its own, after which every process still running is killed."""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, n: int, timeout: float = 120.0):
    """argv (after the interpreter) in n processes -> [(returncode, output)]
    by rank; raises AssertionError with the outputs when the deadline
    passes."""
    port = free_port()
    base = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", JL_COORDINATOR=f"127.0.0.1:{port}",
                JL_NUM_PROCESSES=str(n))
    procs = [subprocess.Popen([sys.executable, *argv], env=dict(base, JL_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-3000:] for p in procs[len(outs):]]
        raise AssertionError(f"{n} processes of {argv} passed {timeout} s:\n" + "\n".join(tails))
    return [(p.returncode, out) for p, out in zip(procs, outs)]
