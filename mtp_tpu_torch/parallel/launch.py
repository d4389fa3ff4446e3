"""A world of ranks, one process each, running one function.

``World(fn, world, workdir, **kwargs)`` starts `world` processes at once;
each joins a process group (gloo, or NCCL with rank r on card r) through a
``FileStore`` in `workdir` (no port to collide on), runs
``fn(rank=..., world=..., **kwargs)`` and pickles its result.
:meth:`World.results` waits for all of them up to the world's own time
limit; a rank that fails or a world that outlives the limit kills every rank
and raises, so a hung rendezvous fails instead of stalling the caller.
:func:`spawn` is the one-call form in a temporary directory.

`fn` is ``"module:function"``, importable in the ranks. Run as a module,
this file is one rank: ``python -m mtp_tpu_torch.parallel.launch FN RANK
WORLD BACKEND STORE INPUTS OUTPUT THREADS``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package


class World:
    """`world` rank processes of ``fn(rank=, world=, **kwargs)``.

    Args:
      fn: ``"module:function"``.
      world: the number of ranks.
      workdir: a fresh directory for the store, the inputs, the results and
        one log per rank (``rank{r}.log``).
      timeout: seconds from the start until every rank must have ended.
      backend: ``"gloo"`` or ``"nccl"`` (rank r on card r).
      threads: intra-op threads per rank (None: torch's default).
      path: directories to put before the package's on the ranks'
        ``PYTHONPATH`` (where `fn`'s module lives).
      env: variables to set in the ranks' environment.
    """

    def __init__(self, fn: str, world: int, workdir, *, timeout: float = 600.0,
                 backend: str = "gloo", threads: int | None = None, path=(), env=None,
                 **kwargs):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.world = world
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        inp = self.workdir / "inputs.pkl"
        inp.write_bytes(pickle.dumps(kwargs))
        paths = [str(p) for p in path] + [str(ROOT)] + [
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
        child_env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), **(env or {}))
        if threads is not None:
            child_env.update(OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads))
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(self.workdir / f"rank{rank}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "mtp_tpu_torch.parallel.launch", fn, str(rank),
                 str(world), backend, str(self.workdir / "store"), str(inp),
                 str(self._out(rank)), str(threads or 0)],
                cwd=ROOT, env=child_env, stdout=log, stderr=subprocess.STDOUT,
            ))

    def _out(self, rank: int) -> Path:
        return self.workdir / f"rank{rank}.pkl"

    def log(self, rank: int) -> str:
        return (self.workdir / f"rank{rank}.log").read_text()

    def _tails(self) -> str:
        return "\n".join(f"--- rank {r} ---\n{self.log(r)[-3000:]}" for r in range(self.world))

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


def spawn(fn: str, world: int, **kw) -> list:
    """Run `fn` on a world of `world` rank processes (:class:`World`'s
    arguments) in a temporary directory; returns every rank's result and
    prints rank 0's log."""
    with tempfile.TemporaryDirectory(prefix="mtp_world_") as d:
        w = World(fn, world, d, **kw)
        try:
            out = w.results()
        finally:
            w.kill()
        sys.stdout.write(w.log(0))
    return out


def _rank_main(fn, rank, world, backend, store, inp, out, threads):
    import importlib

    import torch
    import torch.distributed as dist

    from mtp_tpu_torch.parallel.comm import init_world

    if int(threads):
        torch.set_num_threads(int(threads))
    rank, world = int(rank), int(world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_world(rank, world, store, backend=backend, timeout_s=300.0)
    try:
        mod, name = fn.split(":")
        kwargs = pickle.loads(Path(inp).read_bytes())
        res = getattr(importlib.import_module(mod), name)(rank=rank, world=world, **kwargs)
        Path(out).write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
