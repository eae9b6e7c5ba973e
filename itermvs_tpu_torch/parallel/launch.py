"""Start the ranks of a process group on this host, for callers that do
not run under torchrun (the dry run of `entry.py`, chip_smoke's
data-parallel phases).

Each rank is a fresh `python -c` process, started from the directory
that holds the package (so that it imports without being installed),
which imports `module` and calls `module.function(rank, world, port,
*args)` with every argument a string. That function joins the group
itself (MASTER_ADDR 127.0.0.1, MASTER_PORT `port`) and leaves its
results in a file of its own. The ranks get a deadline: one that fails
or outlives it stops them all.
"""
from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankFailed(RuntimeError):
    """A rank exited with a non-zero code or passed the deadline."""


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, function: str, args, world: int, timeout: float,
              env=None) -> None:
    """Run `module.function(rank, world, port, *args)` in `world` processes
    and wait for all. Raises `RankFailed` with the end of each failed
    rank's output once a rank fails or `timeout` seconds pass; every rank
    still running is killed first."""
    port = free_port()
    code = f"import sys, {module}; {module}.{function}(*sys.argv[1:])"
    procs = []
    late = False
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+")) for _ in range(world)]
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(r), str(world), str(port),
                     *map(str, args)], cwd=ROOT, env=env, stdout=logs[r],
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    late = True
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            outputs = []
            for r in failed:
                logs[r].seek(0)
                outputs.append(logs[r].read())
            why = f", past the {timeout} s deadline" if late else ""
            raise RankFailed("\n".join(
                f"rank {r} of {world} failed ({procs[r].returncode}{why}):\n"
                f"{out[-3000:]}" for r, out in zip(failed, outputs)))
