"""The sharded steps in the JAX package's GSPMD layout.

Port of fluidsimulation_tpu/parallel/sharding.py. There the whole step is
jitted with NamedSharding annotations and XLA's GSPMD partitioner inserts
the collectives: particles split in row blocks, u, w and phi along y, v
along z. PyTorch has no partitioner. The port keeps the layout at its
entry points (``state_shardings``, ``shard_state``, ``unshard_state``) and
runs, inside ``make_sharded_step``, the multi-rank halo step of
parallel/halo_step.py: one reshard of the grids into x-slabs before it and
one back after it, each an all-gather of the four grids (``World.calls``
counts both as "reshard"). That is the same step with its collectives
written out, the form the JAX package itself calls the hand-scheduled one
(sharding.py:18-21). ``make_sharded_apic_step`` does the same for the APIC
family with parallel/halo_apic.py.

``make_mesh`` returns the World of the calling rank: a mesh is the set of
ranks that parallel/comm.py's ``Ranks`` or ``run_ranks`` spawned.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import SimConfig
from ..core.state import ApicState, SimState
from . import comm
from .halo_apic import make_halo_apic_step
from .halo_step import make_halo_step

# The split dimension of each field (None: not split).
_SPLIT = {"pos": 0, "vel": 0, "C": 0, "u": 1, "v": 2, "w": 1, "phi": 1}


def make_mesh() -> comm.World:
    """The calling rank's World (its process group must be initialised:
    call inside a function that Ranks.run or run_ranks runs)."""
    return comm.current_world()


def state_shardings(world: comm.World) -> SimState:
    """The dimension each SimState field is split along over the ranks
    (JAX's layout, sharding.py:41-51): particle rows, y for u, w and phi,
    z for v."""
    return SimState(**{k: _SPLIT[k] for k in ("pos", "vel", "u", "v", "w", "phi")})


def apic_state_shardings(world: comm.World) -> ApicState:
    """state_shardings plus C's particle rows (sharding.py:79-90)."""
    return ApicState(**{k: _SPLIT[k] for k in ("pos", "vel", "C", "u", "v", "w", "phi")})


def _fields(state):
    return [(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
            if f.name != "k1" and getattr(state, f.name) is not None]


def _split(state, world: comm.World):
    out = {}
    for name, t in _fields(state):
        dim = _SPLIT[name]
        if t.shape[dim] % world.size:
            raise ValueError(f"{name} {tuple(t.shape)}: dimension {dim} must divide over "
                             f"{world.size} ranks")
        out[name] = t.chunk(world.size, dim)[world.rank].clone()
    return type(state)(**out)


def _gather_along(world: comm.World, t, dim: int):
    if dim == 0:
        return comm.all_gather(world, t)
    return comm.all_gather(world, t.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


def shard_state(state: SimState, world: comm.World) -> SimState:
    """This rank's part of a whole SimState in the GSPMD layout. A k1 is
    dropped: the sharded steps run advection uncached, as JAX's do."""
    return _split(state, world)


def shard_apic_state(state: ApicState, world: comm.World) -> ApicState:
    return _split(state, world)


def unshard_state(local, world: comm.World):
    """The whole state on every rank from the ranks' GSPMD-layout parts (one
    all-gather a field)."""
    return type(local)(**{name: _gather_along(world, t, _SPLIT[name])
                          for name, t in _fields(local)})


def _to_slabs(world: comm.World, local):
    """GSPMD layout -> the halo step's x-slabs: the grids all-gathered,
    this rank's x planes kept; the particle blocks are the same rows."""
    world.calls["reshard"] += 1
    sx = local.phi.shape[0] // world.size
    x0 = world.rank * sx
    out = {}
    for name, t in _fields(local):
        if _SPLIT[name] == 0:
            out[name] = t
            continue
        g = _gather_along(world, t, _SPLIT[name])
        out[name] = g[x0 + 1:x0 + sx + 1] if name == "u" else g[x0:x0 + sx]
        out[name] = out[name].clone()
    return type(local)(**out)


def _from_slabs(world: comm.World, local):
    """The halo step's x-slabs -> the GSPMD layout."""
    world.calls["reshard"] += 1
    out = {}
    for name, t in _fields(local):
        dim = _SPLIT[name]
        if dim == 0:
            out[name] = t
            continue
        g = comm.all_gather(world, t)
        if name == "u":
            g = torch.cat([torch.zeros_like(g[:1]), g], 0)
        out[name] = g.chunk(world.size, dim)[world.rank].clone()
    return type(local)(**out)


def _wrap(world: comm.World, halo_step, with_diagnostics: bool):
    def step_fn(state, dt):
        out = halo_step(_to_slabs(world, state), dt)
        if with_diagnostics:
            return _from_slabs(world, out[0]), out[1]
        return _from_slabs(world, out)

    return step_fn


def make_sharded_step(cfg: SimConfig, world: comm.World, capacity: int | None = None,
                      with_diagnostics: bool = False):
    """step(state, dt) on this rank's part of a SimState in the GSPMD
    layout (shard_state); returns its part of the next state."""
    return _wrap(world, make_halo_step(cfg, world, capacity, with_diagnostics),
                 with_diagnostics)


def make_sharded_apic_step(cfg: SimConfig, world: comm.World, capacity: int | None = None,
                           with_diagnostics: bool = False):
    """The APIC step on this rank's part of an ApicState in the GSPMD
    layout (shard_apic_state)."""
    return _wrap(world, make_halo_apic_step(cfg, world, capacity, with_diagnostics),
                 with_diagnostics)
