"""The transport of the sharded path: ring shifts and reductions over a grid
of ranks, on ``torch.distributed``.

The JAX package runs every shard in one program under ``shard_map``, with
``ppermute``, ``psum`` and ``pmax`` as collectives inside it
(``sharded_md.py:279-296``, ``sharded_window.py:219-245,541-546``). The port
runs one process per rank instead, and :class:`Comm` stands in for those
collectives:

* :meth:`Comm.shift` / :meth:`Comm.shifts` — the ring ``ppermute`` along one
  axis of the rank grid: each rank sends to its neighbor at ``+direction``
  and receives from the one at ``-direction``, built from
  ``dist.batch_isend_irecv``. An axis of size 1 sends nothing and returns
  the input. On an axis of size 2 the left and right neighbors are one peer:
  the messages of one batch are told apart by their tags (gloo) and by the
  order they are posted in (NCCL matches a pair's sends and receives in
  order), and every rank posts them in the same order.
* :meth:`Comm.sum` / :meth:`Comm.max` — all-gather, then a reduction over
  the ranks in rank order. Every rank adds the same values in the same
  order, so a replicated quantity (the cell, the energy, the thermostat
  chains) is bit-equal on every rank, and a run repeats bit for bit on one
  rank count.

Transports (``Comm.transport``):

* ``"nccl"`` — device tensors through NCCL; the production transport.
* ``"gloo"`` — CPU tensors through gloo (the CPU tests).
* ``"gloo-staged"`` — device tensors through gloo, staged through host
  memory here, explicitly: each message is copied to the host, sent, and
  copied back. It lets several ranks share one card, which NCCL refuses. It
  is chosen by the caller and never taken as a fallback: ``"gloo"`` refuses
  a device tensor.

A world of one rank is an ordinary process group of size 1: an axis of one
rank sends nothing, and the reductions gather one part.

A 2-D grid ``(n0, n1)`` is flattened brick-major (rank = i0 * n1 + i1), the
order of :func:`~mtp_tpu_torch.parallel.domain.partition_bricks`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "gloo-staged")


def init_world(rank: int, world: int, store_file: str, *, backend: str = "gloo",
               timeout_s: float = 120.0) -> None:
    """``dist.init_process_group`` through a ``FileStore`` at `store_file`
    (a fresh path per world: no port to collide on between test workers)."""
    import datetime

    store = dist.FileStore(store_file, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Comm:
    """A rank grid over a process group, with the sharded path's messages.

    Args:
      grid: the rank grid, ``(world,)`` (slabs) or ``(n0, n1)`` (bricks);
        default ``(world,)``.
      group: the process group (default: the world's, which must be
        initialised, by :func:`init_world` or ``dist.init_process_group``).
      transport: ``"gloo-staged"`` to stage device tensors through the host
        over a gloo group; otherwise the group's backend (``"nccl"`` or
        ``"gloo"``).
    """

    def __init__(self, grid=None, *, group=None, transport: str | None = None):
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("Comm needs an initialised process group (init_world)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
        if transport is None:
            transport = backend
        if transport not in TRANSPORTS or backend != transport.split("-")[0]:
            raise ValueError(f"transport {transport!r} on a {backend!r} process group")
        self.transport = transport
        self.grid = tuple(int(g) for g in (grid or (self.world,)))
        if len(self.grid) not in (1, 2) or int(np.prod(self.grid)) != self.world:
            raise ValueError(f"rank grid {self.grid} does not hold a world of {self.world}")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.grid))

    # ------------------------------------------------------------ plumbing

    def _peer(self, axis: int, step: int) -> int:
        """Global rank of the neighbor `step` along `axis` (periodic)."""
        c = list(self.coords)
        c[axis] = (c[axis] + step) % self.grid[axis]
        r = int(np.ravel_multi_index(c, self.grid))
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _out(self, x):
        """`x` as the transport sends it."""
        if x.device.type == "cpu":
            return x.contiguous()
        if self.transport == "nccl":
            return x.contiguous()
        if self.transport == "gloo-staged":
            return x.detach().cpu()
        raise TypeError(
            f"transport {self.transport!r} takes CPU tensors; for device tensors over gloo "
            "ask for transport='gloo-staged'"
        )

    def _in(self, like):
        """An empty receive buffer where the transport receives `like`."""
        dev = like.device if self.transport == "nccl" else "cpu"
        return torch.empty(like.shape, dtype=like.dtype, device=dev)

    # ------------------------------------------------------------ messages

    def shifts(self, items, axis: int):
        """Several ring shifts along `axis` as one batch: `items` is a list of
        ``(tensor, direction)`` with direction +1 or -1; returns, for each,
        the tensor received from the neighbor at ``-direction`` (same shape
        and dtype). An axis of size 1 returns the inputs."""
        if self.grid[axis] == 1:
            return [x for x, _ in items]
        sends = [self._out(x) for x, _ in items]
        recvs = [self._in(s) for s in sends]
        ops = [dist.P2POp(dist.isend, s, self._peer(axis, d), self.group, tag=self._tag(axis, d))
               for s, (_, d) in zip(sends, items)]
        ops += [dist.P2POp(dist.irecv, r, self._peer(axis, -d), self.group,
                           tag=self._tag(axis, d))
                for r, (_, d) in zip(recvs, items)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(x.device) for r, (x, _) in zip(recvs, items)]

    @staticmethod
    def _tag(axis: int, direction: int) -> int:
        return 2 * axis + (direction > 0)

    def shift(self, x, axis: int, direction: int):
        """The ring ``ppermute`` along `axis`: send `x` to the neighbor at
        `direction`, return what the neighbor at ``-direction`` sent."""
        return self.shifts([(x, direction)], axis)[0]

    def all_gather(self, x):
        """(world, ...) stack of every rank's `x`, in rank order."""
        was_bool = x.dtype == torch.bool
        s = self._out(x.to(torch.uint8) if was_bool else x)
        parts = [torch.empty_like(s) for _ in range(self.world)]
        dist.all_gather(parts, s, group=self.group)
        out = torch.stack(parts).to(x.device)
        return out.bool() if was_bool else out

    def sum(self, x):
        """Sum over the ranks, in rank order (bit-equal on every rank)."""
        parts = self.all_gather(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def max(self, x):
        """Elementwise max over the ranks (OR for bool tensors)."""
        return torch.amax(self.all_gather(x), dim=0)

    def barrier(self) -> None:
        dist.barrier(group=self.group)
