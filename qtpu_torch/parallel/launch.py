"""Start a world of ranks: ``n`` processes of one command, each with the
``QTPU_*`` variables ``parallel.initialize_from_env`` reads.

    from qtpu_torch.parallel.launch import run_world
    results = run_world([sys.executable, "worker.py"], 2, rdzv="/tmp/r")

The rendezvous is a file (``file://`` + ``rdzv``, which must not exist
yet), so concurrent worlds on one host never race for a port.  The world
has a deadline: past ``timeout_s`` every rank still running is killed and
:class:`WorldTimeout` raised with what each printed.  Every rank's output
goes to a file beside the rendezvous (no pipe can fill and stall a rank).
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence


class RankResult(NamedTuple):
    rank: int
    returncode: int
    output: str


class WorldTimeout(RuntimeError):
    """A world outlived its deadline; its ranks were killed."""


def world_env(rank: int, n: int, rdzv: str,
              backend: Optional[str] = None) -> Dict[str, str]:
    """The variables of one rank of a world of ``n`` meeting at ``rdzv``."""
    env = {"QTPU_COORDINATOR": "file://" + os.path.abspath(rdzv),
           "QTPU_NUM_PROCESSES": str(n), "QTPU_PROCESS_ID": str(rank),
           "QTPU_LOCAL_RANK": str(rank)}
    if backend:
        env["QTPU_DIST_BACKEND"] = backend
    return env


def start_world(cmd: Sequence[str], n: int, rdzv: str, *,
                backend: Optional[str] = None,
                env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None):
    """Start the ``n`` ranks; returns ``[(Popen, output path)]``."""
    if os.path.exists(rdzv):
        raise FileExistsError(f"rendezvous file {rdzv} exists already")
    procs = []
    for r in range(n):
        e = dict(os.environ if env is None else env)
        e.update(world_env(r, n, rdzv, backend))
        out = Path(f"{rdzv}.rank{r}.log")
        with open(out, "w") as fh:
            procs.append((subprocess.Popen(list(cmd), env=e, cwd=cwd,
                                           stdout=fh,
                                           stderr=subprocess.STDOUT),
                          out))
    return procs


def kill_world(procs) -> None:
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
    for p, _ in procs:
        p.wait()


def join_world(procs, timeout_s: float) -> List[RankResult]:
    """Wait for every rank; past ``timeout_s`` kill them all and raise."""
    deadline = time.monotonic() + timeout_s
    try:
        for p, _ in procs:
            left = deadline - time.monotonic()
            p.wait(timeout=max(left, 0.01))
    except subprocess.TimeoutExpired:
        kill_world(procs)
        outs = "\n".join(f"--- rank {r}:\n{out.read_text()}"
                         for r, (_, out) in enumerate(procs))
        raise WorldTimeout(f"world of {len(procs)} ranks outlived "
                           f"{timeout_s} s; killed\n{outs}") from None
    return [RankResult(r, p.returncode, out.read_text())
            for r, (p, out) in enumerate(procs)]


def run_world(cmd: Sequence[str], n: int, rdzv: str, *,
              timeout_s: float = 60.0, backend: Optional[str] = None,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[RankResult]:
    """Run ``cmd`` as ``n`` ranks to their end (or kill them at
    ``timeout_s``); returns each rank's exit code and output."""
    procs = start_world(cmd, n, rdzv, backend=backend, env=env, cwd=cwd)
    try:
        return join_world(procs, timeout_s)
    finally:
        kill_world(procs)
