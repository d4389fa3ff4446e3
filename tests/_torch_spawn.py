"""A world of gloo ranks for the port's CPU tests: one subprocess per rank.

``World(fn, world, workdir, **kwargs)`` starts `world` processes at once;
each joins a gloo process group (``backend="nccl"``: an NCCL group, rank r
on card r) through a ``FileStore`` in `workdir` (no port to collide on
between test workers), runs ``fn(rank=..., world=..., **kwargs)`` on one
intra-op thread and pickles its result. ``results()``
waits for all of them up to the world's own time limit; a rank that fails or
a world that outlives the limit kills every rank and raises, so a hung
rendezvous fails its tests instead of stalling the suite.

`fn` is ``"module:function"`` of a module that imports torch and the port
only (the ranks import no jax). Run as a script, this file is one rank.

``world_of_one(workdir)`` is the in-process case: a gloo world of one rank
in the calling process, destroyed on exit.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent


class World:
    def __init__(self, fn: str, world: int, workdir, *, timeout: float = 120.0,
                 backend: str = "gloo", **kwargs):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.world = world
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        inp = self.workdir / "inputs.pkl"
        inp.write_bytes(pickle.dumps(kwargs))
        path = [str(REPO), str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = []
        self.logs = []
        for rank in range(world):
            log = open(self.workdir / f"rank{rank}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, fn, str(rank), str(world), backend,
                 str(self.workdir / "store"), str(inp), str(self._out(rank))],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            ))

    def _out(self, rank: int) -> Path:
        return self.workdir / f"rank{rank}.pkl"

    def _tails(self) -> str:
        parts = []
        for rank in range(self.world):
            text = (self.workdir / f"rank{rank}.log").read_text()
            parts.append(f"--- rank {rank} ---\n{text[-3000:]}")
        return "\n".join(parts)

    def results(self) -> list:
        """Every rank's result, in rank order; raises if a rank failed or
        the world ran past its time limit."""
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError(f"world of {self.world} ranks ran past {self.timeout} s; "
                               f"killed\n{self._tails()}") from None
        finally:
            for log in self.logs:
                log.close()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed\n{self._tails()}")
        return [pickle.loads(self._out(r).read_bytes()) for r in range(self.world)]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


@contextlib.contextmanager
def world_of_one(workdir):
    """A gloo process group of one rank in this process, for the block."""
    import torch.distributed as dist

    from mtp_tpu_torch.parallel.comm import init_world

    init_world(0, 1, str(Path(workdir) / "store"), timeout_s=30.0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world, backend, store, inp, out):
    import importlib

    import torch
    import torch.distributed as dist

    from mtp_tpu_torch.parallel.comm import init_world

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_world(rank, world, store, backend=backend, timeout_s=100.0)
    try:
        mod, name = fn.split(":")
        kwargs = pickle.loads(Path(inp).read_bytes())
        res = getattr(importlib.import_module(mod), name)(rank=rank, world=world, **kwargs)
        Path(out).write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
