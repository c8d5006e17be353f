"""Spawn the ranks of a CPU process group for a test (the sharded EKF's and
the lane sharding's tests)."""

from __future__ import annotations

import time

import torch.multiprocessing as mp


def spawn(fn, world: int, args: tuple, time_limit: float):
    """fn(rank, world, *args) in world spawned processes, within time_limit
    seconds; a rank that raises fails the spawn with its traceback."""
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + time_limit
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {time_limit} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
