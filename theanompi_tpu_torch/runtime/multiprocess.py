"""Multi-process launch on one machine — the ``mpirun -np N`` analog,
counterpart of ``theanompi_tpu.runtime.multiprocess.spawn_local``.

``spawn_local(N, argv)`` starts N children of ``python -m
theanompi_tpu_torch.launch <argv>``, each with the ``env://`` variables
that ``runtime.dist`` reads: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Each child
is one rank on one device: ``cuda:LOCAL_RANK`` with NCCL when there are
as many cards as ranks, ``cuda:(LOCAL_RANK % cards)`` over gloo when
ranks share a card, gloo on the CPU under ``--device cpu``.  When one
child exits non-zero the others are terminated (a surviving BSP rank
would wait at its next collective until the timeout).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(rank: int, n_procs: int, port: int,
               env_extra: Optional[Dict[str, str]]) -> Dict[str, str]:
    env = dict(os.environ)
    # the children import this package from the same checkout
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    env.update(RANK=str(rank), WORLD_SIZE=str(n_procs),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n_procs),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env.update(env_extra or {})
    return env


def spawn_local(
    n_procs: int,
    argv: Sequence[str],
    env_extra: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = 900.0,
    stream_output: bool = True,
) -> List[int]:
    """Run ``python -m theanompi_tpu_torch.launch <argv>`` × N as one
    process group on this machine.  Returns the exit codes; raises
    ``RuntimeError`` when a child fails (after terminating the rest) or
    the timeout passes."""
    port = find_free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "theanompi_tpu_torch.launch", *argv],
            env=_child_env(rank, n_procs, port, env_extra),
            stdout=None if stream_output else subprocess.DEVNULL,
            stderr=None if stream_output else subprocess.STDOUT,
        )
        for rank in range(n_procs)
    ]
    deadline = time.monotonic() + timeout if timeout else None
    codes: List[Optional[int]] = [None] * n_procs
    try:
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            if any(c not in (None, 0) for c in codes):
                break  # fail fast
            if deadline and time.monotonic() > deadline:
                raise RuntimeError(
                    f"distributed launch timed out after {timeout}s "
                    f"(exit codes so far: {codes})")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for i, p in enumerate(procs):
            if codes[i] is None:
                try:
                    codes[i] = p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes[i] = p.wait()
    if any(c != 0 for c in codes):
        raise RuntimeError(f"distributed launch failed: exit codes {codes}")
    return [int(c) for c in codes]
