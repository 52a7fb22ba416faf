"""Map shards within a process and across processes (port of
``shermbot_navigation_tpu.parallel.mesh``).

The JAX package puts one map shard on each device of a ``('data', 'map')``
mesh. Here a map shard is a slot on a leading LOCAL-SHARD axis of every
sharded tensor: one process holds ``L`` of them (``local_shards``), and
the P processes of a map group hold ``S = P * L`` in all, shard
``rank * L + l`` being slot ``l`` of process ``rank``. The same per-shard
code, vectorised over the local-shard axis, then serves one process with S
shards on one device, P processes on the CPU, and P processes sharing one
card. The JAX collectives over ``'map'`` become the methods of
:class:`MapMesh`:

==========================  ==============================================
JAX (``'map'`` axis)         ``MapMesh``
==========================  ==============================================
``psum(x)``                  :meth:`MapMesh.psum`: ``x.sum(0)``, then an
                             all-reduce over the map group if P > 1
``pmin(x)``                  :meth:`MapMesh.pmin`
``all_gather(x, tiled)``     :meth:`MapMesh.all_gather`: the local shards
                             concatenated, then gathered over the group
``axis_index('map')``        :meth:`MapMesh.shard_ids`
==========================  ==============================================

A reduction returns the one replicated value, without the local-shard
axis (it broadcasts against the per-shard tensors). A ``'data'`` axis
splits the processes into map groups, each with worlds of its own.

The backend is the caller's (:func:`initialize_distributed`): ``gloo`` on
the CPU, and for several processes that share one card; ``nccl`` only
where each rank has a card of its own (:func:`make_mesh` raises
otherwise). Under gloo a collective of a tensor on the card goes through
the host EXPLICITLY: one copy to the host and one back, counted in
``MapMesh.host_copies`` (the arithmetic stays on the card).
"""

from __future__ import annotations

import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve


class MapMesh:
    """The map shards this process holds and the group it reduces over.

    ``local_shards`` (L) shards of ``shards`` (S) in all, this process
    being ``rank`` of the ``procs`` processes of its map group (``group``,
    None when ``procs`` is 1), on ``device``. ``process_index`` /
    ``process_count`` place it among every process (data axis
    included). ``collectives``, ``host_copies`` and ``collective_s``
    count the cross-process collectives, their host round trips and
    their host time."""

    def __init__(self, local_shards: int = 1, device=None, *, group=None,
                 rank: int = 0, procs: int = 1, process_index: int = 0,
                 process_count: int = 1, stage_on_host: bool = False):
        if local_shards < 1 or procs < 1 or not 0 <= rank < procs:
            raise ValueError(f"mesh of {local_shards} local shards, rank "
                             f"{rank} of {procs}")
        if procs > 1 and group is None:
            raise ValueError("a mesh of several processes needs its group")
        self.local_shards = local_shards
        self.procs = procs
        self.rank = rank
        self.shards = local_shards * procs
        self.device = resolve(device)
        self.group = group
        self.process_index = process_index
        self.process_count = process_count
        self.stage_on_host = stage_on_host
        self.collectives = 0
        self.host_copies = 0
        self.collective_s = 0.0

    def __repr__(self):
        return (f"MapMesh(shards={self.shards}, local_shards="
                f"{self.local_shards}, rank={self.rank}/{self.procs}, "
                f"device={self.device})")

    def shard_ids(self) -> torch.Tensor:
        """Global index of each local shard, (L,) int64 on the device."""
        return (self.rank * self.local_shards
                + torch.arange(self.local_shards, device=self.device))

    def offsets(self, n_local: int) -> torch.Tensor:
        """Global index of each local shard's first slot, (L, 1), to
        broadcast against (L, B) tensors."""
        return (self.shard_ids() * n_local)[:, None]

    def _across(self, x: torch.Tensor, op) -> torch.Tensor:
        """``op(x)``, a collective over the group that returns its result,
        on a host copy when gloo meets a tensor on the card."""
        t0 = time.perf_counter()
        self.collectives += 1
        staged = self.stage_on_host and x.is_cuda
        out = op(x.cpu() if staged else x.contiguous())
        if staged:
            out = out.to(x.device)
            self.host_copies += 1
        self.collective_s += time.perf_counter() - t0
        return out

    def _all_reduce(self, x: torch.Tensor, how) -> torch.Tensor:
        def op(h):
            dist.all_reduce(h, how, group=self.group)
            return h
        return self._across(x, op)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every shard of ``x`` (L, ...): the replicated (...)."""
        t = x[0] if self.local_shards == 1 else x.sum(0)
        return t if self.procs == 1 else self._all_reduce(
            t, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Minimum over every shard of ``x`` (L, ...)."""
        t = x[0] if self.local_shards == 1 else x.amin(0)
        return t if self.procs == 1 else self._all_reduce(
            t, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's ``x`` (L, ...) concatenated in shard order along
        ``dim`` (negative, an axis of the per-shard tensor): the JAX
        ``all_gather(x, axis, tiled=True)``, replicated, without the
        local-shard axis."""
        if dim >= 0:
            raise ValueError("all_gather takes a negative dim")
        t = x[0] if self.local_shards == 1 else torch.cat(x.unbind(0), dim)
        if self.procs == 1:
            return t

        def op(h):
            parts = [torch.empty_like(h) for _ in range(self.procs)]
            dist.all_gather(parts, h, group=self.group)
            return torch.cat(parts, dim)
        return self._across(t, op)

    def reset_counts(self) -> None:
        self.collectives = self.host_copies = 0
        self.collective_s = 0.0


def initialize_distributed(backend: str, init_method: str, rank: int,
                           world_size: int) -> None:
    """Join a ``torch.distributed`` cluster (the JAX package's
    ``initialize_multihost``): ``init_method`` such as
    ``tcp://localhost:<port>``; nothing here reads the environment."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _require_own_cards(device: torch.device, world: int) -> None:
    """Raise unless every rank has a card no other rank has (NCCL cannot
    put two ranks on one device)."""
    probe = dist.new_group(backend="gloo")
    mine = (socket.gethostname(), device.type, device.index)
    every = [None] * world
    dist.all_gather_object(every, mine, group=probe)
    dist.destroy_process_group(probe)
    if device.type != "cuda" or len(set(every)) < world:
        raise ValueError(
            f"nccl needs a card of its own for each rank; the {world} ranks "
            f"are on {every}: use gloo for ranks that share a card")


def make_mesh(data: int = 1, map_: int | None = None, local_shards: int = 1,
              device=None) -> MapMesh:
    """A ``('data', 'map')`` layout of ``map_`` map shards (S, default
    ``local_shards``: one process) in each of ``data`` map groups, this
    process holding ``local_shards`` of them. The processes (``data *
    map_ / local_shards``) must be those of the initialized
    ``torch.distributed`` cluster, rank ``d * P + r`` being process r of
    map group d; one process touches no ``torch.distributed`` at all.
    Every process calls this (the groups are made collectively)."""
    device = resolve(device)
    S = local_shards if map_ is None else map_
    if S % local_shards:
        raise ValueError(f"map={S} is not a multiple of local_shards="
                         f"{local_shards}")
    procs = S // local_shards
    world = data * procs
    if world == 1:
        return MapMesh(local_shards, device)
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise ValueError(
            f"data={data} x map={S} / local_shards={local_shards} needs a "
            f"cluster of {world} processes (initialize_distributed)")
    backend = dist.get_backend()
    if backend == "nccl":
        _require_own_cards(device, world)
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(d * procs, (d + 1) * procs)))
              for d in range(data)] if procs > 1 else [None] * data
    return MapMesh(local_shards, device, group=groups[rank // procs],
                   rank=rank % procs, procs=procs, process_index=rank,
                   process_count=world,
                   stage_on_host=backend == "gloo" and device.type == "cuda")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster_worker(fn, rank, procs, backend, init_method, args, results):
    try:
        initialize_distributed(backend, init_method, rank, procs)
        # by value: a tensor sent as shared memory would die with its
        # process, which may exit before the parent reads it
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def run_cluster(fn, procs: int, *args, backend: str = "gloo",
                timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``procs`` fresh processes (the ``spawn``
    start method) that form a ``torch.distributed`` cluster on
    ``tcp://localhost``; return each rank's result, in rank order. ``fn``
    and its arguments and results must pickle (``fn`` by import path). A
    rank that raises, dies or outlives ``timeout`` seconds fails the run:
    every process still alive is killed (its peers would wait on it in a
    collective) and ``RuntimeError`` carries each rank's traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    ps = [ctx.Process(target=_cluster_worker,
                      args=(fn, r, procs, backend, init, args, results))
          for r in range(procs)]
    for p in ps:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < procs and time.monotonic() < deadline:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in ps):
                    break
                continue
            got[rank] = (ok, out)
            if not ok:
                break
    finally:
        ok_all = len(got) == procs and all(v[0] for v in got.values())
        for p in ps:
            p.join(timeout=30 if ok_all else 0)
            if p.is_alive():
                p.kill()
                p.join()
    if not ok_all:
        why = "\n".join(f"rank {r}: {got[r][1] if r in got else 'no result '
                                       f'(exit code {ps[r].exitcode})'}"
                        for r in range(procs) if not got.get(r, (0,))[0])
        raise RuntimeError(f"cluster of {procs} failed:\n{why}")
    return [pickle.loads(got[r][1]) for r in range(procs)]
