"""Rank-side runs of the five multi-rank paths, for ``Ranks.run`` /
``run_ranks``: the module ``python -m fluidsimulation_tpu_torch.parallel``
and tests/test_torch_parallel.py (on the CPU and, marked ``cuda``, on the
card) call them. Each takes the rank's World first and returns picklable
values (numpy arrays, numbers): the whole result on rank 0, and on every
rank its per-step counts of collective calls (World.calls) and of kernel
launches.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core import cuda_pack
from ..core.config import SimConfig
from ..core.state import init_state
from ..ops import cuda_g2p, cuda_interp, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep
from ..solver.apic import init_apic_state
from ..utils.profiling import hooked
from . import comm
from .halo import sor_pressure_sharded, x_slab
from .halo_apic import make_halo_apic_step, shard_apic_state_x
from .halo_step import make_halo_step, shard_state_x, unshard_state_x
from .sharding import (
    make_sharded_apic_step,
    make_sharded_step,
    shard_apic_state,
    shard_state,
    unshard_state,
)

# Every kernel entry point, by its C symbol.
KERNELS = (cuda_seed.KERNEL, cuda_sweep.KERNEL, cuda_sweep.CARRY_KERNEL, cuda_p2g.KERNEL,
           cuda_sor.KERNEL, cuda_sor.HALF_KERNEL, cuda_g2p.KERNEL, cuda_pack.KERNEL,
           cuda_interp.KERNEL)

# (family, layout) -> (shard, make_step, unshard)
PATHS = {
    ("flip", "x"): (shard_state_x, make_halo_step, unshard_state_x),
    ("apic", "x"): (shard_apic_state_x, make_halo_apic_step, unshard_state_x),
    ("flip", "gspmd"): (shard_state, make_sharded_step, unshard_state),
    ("apic", "gspmd"): (shard_apic_state, make_sharded_apic_step, unshard_state),
}


def launches() -> dict:
    return {k.symbol: k.launches for k in KERNELS}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def whole_state(family: str, cfg: SimConfig, device):
    """The dam-break state every rank builds alike (no k1)."""
    if family == "apic":
        return init_apic_state(cfg, device)
    return init_state(cfg, device, with_cache=False)


def to_numpy(state) -> dict:
    return {k: v.cpu().numpy() for k, v in vars(state).items() if v is not None}


def _entry_checks(store: dict) -> dict:
    """The two slab entries against their plain versions on the last
    inputs this rank gave them: max abs difference and whether bit for
    bit."""
    out = {}
    if "carry" in store:
        got = cuda_sweep.sweep_x_carry(*store["carry"])
        want = cuda_sweep.sweep_x_carry_plain(*store["carry"])
        out["sweep_x_carry"] = (max(float((g - w).abs().max()) for g, w in zip(got, want)),
                                all(torch.equal(g, w) for g, w in zip(got, want)))
    if "half" in store:
        args = store["half"]
        got = cuda_sor.sor_half(args[0], args[1].clone(), *args[2:])
        want = cuda_sor.sor_half_plain(args[0], args[1].clone(), *args[2:])
        out["sor_half"] = (float((got - want).abs().max()), torch.equal(got, want))
    return out


def halo_run(world: comm.World, family: str, cfg: SimConfig, n_steps: int, dt: float,
             layout: str = "x", capacity: int | None = None,
             check_entries: bool = False) -> dict:
    """n_steps of the multi-rank step from the dam break. Returns, on every
    rank, the particles dropped, the collective calls and the kernel
    launches of each step; on rank 0 the whole final state.
    ``check_entries``: the last step's inputs to the two slab entries are
    kept and each entry is held against its plain version on them."""
    shard, make_step, unshard = PATHS[(family, layout)]
    for k in KERNELS:
        k.launches = 0
    local = shard(whole_state(family, cfg, world.device), world)
    step = make_step(cfg, world, capacity, with_diagnostics=True)
    out = {"rank": world.rank, "dropped": [], "calls": [], "launches": []}
    store: dict = {}

    def keep(label, orig, args):
        # sor_half updates p (args[1]) in place: keep a copy of its input.
        store[label] = [a.clone() if label == "half" and i == 1 else a
                        for i, a in enumerate(args)]
        return orig(*args)

    for i in range(n_steps):
        last = check_entries and i == n_steps - 1
        world.reset_calls()
        before = launches()
        if last:
            with hooked([("parallel.halo_step", "sweep_x_carry", "carry"),
                         ("parallel.halo", "sor_half", "half")], keep):
                local, dropped = step(local, dt)
        else:
            local, dropped = step(local, dt)
        out["dropped"].append(dropped)
        out["calls"].append(dict(world.calls))
        out["launches"].append(_delta(launches(), before))
    if check_entries:
        out["entries"] = _entry_checks(store)
    whole = unshard(local, world)
    if world.rank == 0:
        out["state"] = to_numpy(whole)
    return out


def sor_run(world: comm.World, cfg: SimConfig, phi, diag, b,
            iterations: int | None = None) -> dict:
    """The halo SOR on each rank's slab of the whole (nx, ny, nz) numpy
    arrays phi, diag, b; rank 0 returns the whole p."""
    t = [torch.from_numpy(np.ascontiguousarray(x_slab(world, a, cfg.nx))).to(world.device)
         for a in (phi, diag, b)]
    out = {"rank": world.rank}
    world.reset_calls()
    before = launches()
    p = sor_pressure_sharded(cfg, world, *t, iterations)
    out["calls"] = dict(world.calls)
    out["launches"] = _delta(launches(), before)
    whole = comm.all_gather(world, p)
    if world.rank == 0:
        out["p"] = whole.cpu().numpy()
    return out


def render_run(world: comm.World, phi, camera, width: int, height: int, tile_h: int = 100,
               tile_w: int = 100, bounces: int = 2, overstep: float = 0.0) -> dict:
    """One sharded frame of the whole numpy level set ``phi`` (camera: the
    four vectors); rank 0 returns the image."""
    from ..render.sharded import make_sharded_render

    frame = make_sharded_render(world, width, height, tile_h, tile_w, bounces, overstep)
    phi_t = torch.from_numpy(np.asarray(phi, dtype=np.float32)).to(world.device)
    out = {"rank": world.rank}
    world.reset_calls()
    img = frame(phi_t, *camera)
    out["calls"] = dict(world.calls)
    if world.rank == 0:
        out["image"] = img.cpu().numpy()
    return out


def imported(world: comm.World) -> list:
    """The modules of JAX or of the JAX package this rank has imported."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                  or m.startswith("jaxlib.") or m == "fluidsimulation_tpu"
                  or m.startswith("fluidsimulation_tpu."))


def layout_run(world: comm.World, cfg: SimConfig) -> dict:
    """The shapes of this rank's part of the dam-break state in each layout,
    and whether gathering the parts gives the whole state back."""
    out = {"rank": world.rank}
    for family in ("flip", "apic"):
        whole = whole_state(family, cfg, world.device)
        for layout in ("x", "gspmd"):
            shard, _, unshard = PATHS[(family, layout)]
            local = shard(whole, world)
            back = unshard(local, world)
            out[(family, layout)] = {
                "shapes": {k: tuple(v.shape) for k, v in vars(local).items() if v is not None},
                "round_trip": all(torch.equal(getattr(back, k), v)
                                  for k, v in vars(whole).items() if v is not None),
            }
    return out
