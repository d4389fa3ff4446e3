"""A world of gloo ranks for the port's CPU tests: one subprocess per rank.

``World(fn, world, workdir, **kwargs)`` is the package's
:class:`mtp_tpu_torch.parallel.launch.World` with this directory on the
ranks' path and one intra-op thread per rank: each rank joins a gloo
process group (``backend="nccl"``: an NCCL group, rank r on card r) through
a ``FileStore`` in `workdir`, runs ``fn(rank=..., world=..., **kwargs)`` and
pickles its result; ``results()`` waits up to the world's own time limit,
and a rank that fails or a world that outlives the limit kills every rank
and raises, so a hung rendezvous fails its tests instead of stalling the
suite.

`fn` is ``"module:function"`` of a module that imports torch and the port
only (the ranks import no jax).

``world_of_one(workdir)`` is the in-process case: a gloo world of one rank
in the calling process, destroyed on exit.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

from mtp_tpu_torch.parallel import launch

TESTS = Path(__file__).resolve().parent


class World(launch.World):
    def __init__(self, fn: str, world: int, workdir, *, timeout: float = 120.0,
                 backend: str = "gloo", **kwargs):
        super().__init__(fn, world, workdir, timeout=timeout, backend=backend, threads=1,
                         path=[TESTS], **kwargs)


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
