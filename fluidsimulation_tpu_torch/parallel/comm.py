"""The ranks' communication: the port's stand-in for JAX's shard_map
collectives (ppermute, all_gather, pmax) over ``torch.distributed``.

JAX runs one program on every device of a mesh; the port runs one process a
rank. Each process calls ``init_world`` (``run_ranks`` and ``Ranks`` do it
for the processes they spawn), which returns its ``World``; the step of a
rank then calls the exchanges below where the JAX package has its
collectives, with the same fills at the domain's edges:

  from_lo, from_hi   one plane from the rank below / above (halo_step.py:72-86)
  halo_x             a slab extended by one x-plane each side (:88-93)
  exchange_x         the boundary planes of both neighbours (halo.py:33-46)
  send / recv        the x-sweep relay's carry plane
  all_gather         equal blocks along dim 0, concatenated in rank order
  pmax               the largest of one integer over the ranks

``World.calls`` counts every call by kind (the names above); the tests pin
the counts of a step, the counterpart of the JAX package's collective
budgets.

Backends. The backend is an explicit argument and nothing switches it:

  * ``nccl`` (the default) puts rank r on cuda:r and raises when there are
    more ranks than cards; NCCL refuses two ranks of one communicator on
    one card.
  * ``gloo`` puts the ranks on the CPU (``device="cpu"``) or on the cards,
    rank r on cuda:(r % cards), so that several ranks share one card. Of
    gloo's calls, all_gather and all_reduce take CUDA tensors; send and
    recv do not (measured with torch 2.11.0+cu128 on an H100: a CUDA
    tensor's send aborts the process with "writev ... Bad address"). So
    under gloo the point-to-point planes of a CUDA slab are staged through
    host buffers, in plain sight (``World.staged``), and the collectives
    take the CUDA tensors.

Every process group gets a finite timeout, so a rank stuck in a collective
raises instead of hanging; ``Ranks`` joins its processes with a deadline
and fails a call with the traceback of the rank that failed.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# gloo call -> whether it takes CUDA tensors (see the module docstring).
GLOO_TAKES_CUDA = {"all_gather": True, "all_reduce": True, "send": False, "recv": False}

DEFAULT_TIMEOUT = 300.0  # seconds a collective may wait before it raises


@dataclasses.dataclass
class World:
    """One rank's view of the world: rank, size, its device, the backend
    and the process group (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def staged(self) -> bool:
        """Whether point-to-point planes go through host buffers (gloo with
        CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda" and not GLOO_TAKES_CUDA["send"]

    def reset_calls(self) -> None:
        self.calls.clear()


_WORLD: World | None = None


def current_world() -> World:
    """The World of this process, set by init_world."""
    if _WORLD is None:
        raise RuntimeError("no world in this process: run inside run_ranks/Ranks, or call "
                           "init_world first")
    return _WORLD


def rank_device(backend: str, device, rank: int, size: int) -> torch.device:
    """Where rank ``rank`` of ``size`` runs; raises on a backend/device pair
    that cannot run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError('backend="nccl" needs CUDA devices; use backend="gloo" for ranks '
                             "on the CPU")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch.cuda.is_available() is false")
    cards = torch.cuda.device_count()
    if backend == "nccl" and size > cards:
        raise ValueError(f'backend="nccl" places one rank a card: {size} ranks, {cards} cards. '
                         f'Use backend="gloo" to share a card between ranks')
    return torch.device("cuda", rank % cards)


def init_world(rank: int, size: int, backend: str, device, store_path: str,
               timeout: float = DEFAULT_TIMEOUT) -> World:
    """Join the process group of ``size`` ranks that meet at the FileStore
    ``store_path``; returns this rank's World."""
    global _WORLD
    dev = rank_device(backend, device, rank, size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, size), rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout), **kw,
    )
    _WORLD = World(rank=rank, size=size, device=dev, backend=backend)
    return _WORLD


def close_world() -> None:
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


# -- point to point -----------------------------------------------------------

def _wire(world: World, t: torch.Tensor) -> torch.Tensor:
    """t as it goes on the wire: contiguous, bool as uint8, on the host when
    the world stages."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.cpu() if world.staged else t


def _unwire(world: World, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        t = t.view(torch.bool)
    return t.to(like.device)


def _p2p(world: World, sends: list, recvs: list) -> list:
    """Post every (tensor, peer) send and every (like, peer) receive as one
    batch, wait for all; returns the received tensors. One batch (an NCCL
    group) so that ranks that each send before they receive cannot wait on
    each other's sends."""
    ops, bufs = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, _wire(world, t), peer, group=world.group))
    for like, peer in recvs:
        buf = torch.empty(like.shape, dtype=torch.uint8 if like.dtype == torch.bool else like.dtype,
                          device="cpu" if world.staged else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=world.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_unwire(world, buf, like) for buf, (like, _) in zip(bufs, recvs)]


def _shift_planes(world: World, up, down, lo_fill, hi_fill):
    """Send ``up`` to the rank above and ``down`` to the rank below; returns
    (from below, from above), the fills at the domain's edges. Either may
    be None (not sent, and its counterpart not received)."""
    r, d = world.rank, world.size
    sends, recvs, slots = [], [], []
    if up is not None:
        if r + 1 < d:
            sends.append((up, r + 1))
        if r > 0:
            recvs.append((up, r - 1))
            slots.append("lo")
    if down is not None:
        if r > 0:
            sends.append((down, r - 1))
        if r + 1 < d:
            recvs.append((down, r + 1))
            slots.append("hi")
    got = dict(zip(slots, _p2p(world, sends, recvs)))
    lo = hi = None
    if up is not None:
        lo = got.get("lo", None)
        if lo is None:
            lo = torch.full_like(up, lo_fill)
    if down is not None:
        hi = got.get("hi", None)
        if hi is None:
            hi = torch.full_like(down, hi_fill)
    return lo, hi


def from_lo(world: World, plane, fill):
    """The plane of the rank below (rank i gets rank i-1's); rank 0 gets
    ``fill``."""
    world.calls["from_lo"] += 1
    return _shift_planes(world, plane, None, fill, fill)[0]


def from_hi(world: World, plane, fill):
    """The plane of the rank above; the last rank gets ``fill``."""
    world.calls["from_hi"] += 1
    return _shift_planes(world, None, plane, fill, fill)[1]


def exchange_x(world: World, local):
    """(lo, hi): the last x-plane of the rank below and the first of the
    rank above, zeros at the domain's edges."""
    world.calls["exchange_x"] += 1
    return _shift_planes(world, local[-1], local[0], 0, 0)


def halo_x(world: World, a, lo_fill, hi_fill):
    """The local (sx, ...) block extended to (sx + 2, ...) with the
    neighbours' boundary x-planes, the fills at the domain's edges."""
    world.calls["halo_x"] += 1
    lo, hi = _shift_planes(world, a[-1], a[0], lo_fill, hi_fill)
    return torch.cat([lo[None], a, hi[None]], 0)


def send(world: World, t, peer: int) -> None:
    world.calls["send"] += 1
    _p2p(world, [(t, peer)], [])


def recv(world: World, like, peer: int):
    """A tensor shaped and typed as ``like`` from ``peer``."""
    world.calls["recv"] += 1
    return _p2p(world, [], [(like, peer)])[0]


# -- collectives --------------------------------------------------------------

def all_gather(world: World, t):
    """Every rank's equal block of t, concatenated along dim 0 in rank
    order (JAX's tiled all_gather)."""
    world.calls["all_gather"] += 1
    t = t.contiguous()
    src = t.view(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(src) for _ in range(world.size)]
    dist.all_gather(parts, src, group=world.group)
    out = torch.cat(parts, 0)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def pmax(world: World, value: int) -> int:
    """The largest of ``value`` over the ranks."""
    world.calls["pmax"] += 1
    t = torch.tensor([value], dtype=torch.int64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.group)
    return int(t.item())


# -- spawning -----------------------------------------------------------------

def _rank_main(rank, size, backend, device, store_path, timeout, tasks, results):
    try:
        torch.set_num_threads(1)
        world = init_world(rank, size, backend, device, store_path, timeout)
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, "done", fn(world, *args, **kwargs)))
            except BaseException:
                results.put((rank, "error", traceback.format_exc()))
                break  # a failed rank leaves the group unusable
    finally:
        close_world()


class Ranks:
    """A world of ``size`` rank processes that stays up across calls.

    ``run(fn, *args)`` calls ``fn(world, *args)`` on every rank and returns
    the results in rank order. ``fn`` must be importable by name (a
    module-level function of this package), and its results picklable (no
    CUDA tensors: return numpy arrays or numbers). The processes are
    spawned (CUDA may already be initialised in the caller), meet at a
    FileStore in a fresh temporary directory (so concurrent worlds never
    share a port), and run with one thread each. A rank that fails, dies or
    misses the deadline fails the call with its traceback; the world is then
    closed."""

    def __init__(self, size: int, backend: str = "nccl", device="cuda",
                 timeout: float = DEFAULT_TIMEOUT, start_deadline: float = 300.0):
        rank_device(backend, device, 0, size)  # raise here, not in the ranks
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self._dir = tempfile.mkdtemp(prefix="fst_world_")
        store = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"fst-rank-{r}",
                        args=(r, size, backend, str(device), store, timeout, self._tasks[r],
                              self._results))
            for r in range(size)
        ]
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", start_deadline)
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str, deadline: float) -> list:
        out, end = {}, time.monotonic() + deadline
        while len(out) < self.size:
            try:
                rank, kind, value = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [(p.name, p.exitcode) for p in self._procs
                        if p.exitcode is not None and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"ranks died waiting for {what}: {dead}")
                if time.monotonic() > end:
                    raise TimeoutError(f"{self.size - len(out)} ranks missed the {deadline} s "
                                       f"deadline for {what}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} failed ({what}):\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.size)]

    def run(self, fn, *args, deadline: float = 600.0, **kwargs) -> list:
        if not self._procs:
            raise RuntimeError("this world is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        try:
            return self._collect(getattr(fn, "__name__", "task"), deadline)
        except BaseException:
            self.close()
            raise

    def close(self, deadline: float = 30.0) -> None:
        """Stop every rank: ask, wait up to ``deadline``, then kill."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        end = time.monotonic() + deadline
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, size: int, backend: str = "nccl", device="cuda", *args,
              timeout: float = DEFAULT_TIMEOUT, deadline: float = 600.0, **kwargs) -> list:
    """Spawn a world of ``size`` ranks, call ``fn(world, *args, **kwargs)``
    on each, close the world; returns the results in rank order."""
    with Ranks(size, backend, device, timeout=timeout) as ranks:
        return ranks.run(fn, *args, deadline=deadline, **kwargs)
