"""The FLIP P2G kernel (csrc/p2g.cu) where its block deals the long runs'
walk out in pieces: on states whose particles pile up.

Marked ``cuda``: each test skips without a CUDA card. On a machine with one
(and nvcc), run them with

    python -m pytest tests/test_torch_p2g_kernel.py -m cuda -q

Each state is made on the CPU, indexed by build_csr on the card and held to
the scatter form (ops/cuda_p2g.py::p2g_accumulate_plain) within
``_p2g_close`` (the kernel sums in another order), and two launches must give
the same bits. The states: wall piles of 1,235 and 3,000 particles in one
cell of a boundary plane, as the advection clamp makes them; a tile whose
only particles lie in one dense cell; dense rows of cells along z, inside
the grid and on its upper edges, whose runs the halo's chunks cut; ragged
shapes with a pile in their upper corner; non-finite positions, which the
CSR index keeps past start[ncell] and the kernel never reads. The window
rule: moving and removing particles outside a face's 27-cell window, which
shifts every halo position and chunk boundary of the tiles around, leaves
that face's bits as they were. The counters: with a recording of
utils/trace.py open a launch adds p2g.visits, the particle visits of every
face's 27-cell window, and p2g.lane_steps, whole rounds of 256 lanes and at
least the visits; with none open it counts nothing and the faces are the
same bits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_cuda import _p2g_close, _p2g_equal, _shape_cfg

from fluidsimulation_tpu_torch.ops import cuda_p2g
from fluidsimulation_tpu_torch.ops.binning import build_csr
from fluidsimulation_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _cells(cfg):
    return np.array([cfg.nx, cfg.ny, cfg.nz], dtype=np.float32)


def _uniform(cfg, rng, per_cell):
    """per_cell particles a cell on average, uniform over the advection
    clamp box; positions in metres."""
    m = _cells(cfg)
    n = int(per_cell * cfg.nx * cfg.ny * cfg.nz)
    return rng.uniform(-0.4 / m, 1.0 - 0.6 / m, size=(n, 3)).astype(np.float32)


def _pile(cfg, rng, cell, n, wall=None):
    """n particles in one cell; with ``wall`` = (axis, side) all of them on
    that boundary plane at the clamp's value (cell units -0.4 or n - 0.6)."""
    m = _cells(cfg)
    p = np.asarray(cell, dtype=np.float32) + rng.uniform(-0.45, 0.45, size=(n, 3))
    if wall is not None:
        axis, side = wall
        p[:, axis] = -0.4 if side == 0 else m[axis] - 0.6
    return (p / m).astype(np.float32)


def _indexed(dev, cfg, pos, seed=0, vel=None):
    """Normal velocities (or ``vel``); (pcs, vels, start) in CSR order on
    the card."""
    if vel is None:
        vel = np.random.default_rng(seed).standard_normal(pos.shape).astype(np.float32)
    pos = torch.from_numpy(np.ascontiguousarray(pos)).to(dev)
    vel = torch.from_numpy(np.ascontiguousarray(vel)).to(dev)
    csr = build_csr(cfg, pos)
    scale = torch.tensor(_cells(cfg), device=dev)
    return (pos * scale)[csr.order], vel[csr.order], csr.start


def _held(cfg, pcs, vels, start):
    """The kernel within _p2g_close of the scatter form, and bit-equal to
    a second launch; its faces."""
    got = cuda_p2g.p2g_accumulate(cfg, pcs, vels, start)
    again = cuda_p2g.p2g_accumulate(cfg, pcs, vels, start)
    n = int(start[-1])
    _p2g_close(cfg, got, cuda_p2g.p2g_accumulate_plain(cfg, pcs[:n], vels[:n]))
    assert _p2g_equal(got, again)
    return got


def _densest(start) -> int:
    return int((start[1:] - start[:-1]).max())


@pytest.mark.parametrize("count", [1235, 3000])
@pytest.mark.parametrize("wall", [(0, 0), (1, 0), (2, 1)], ids=["x0", "floor", "z_top"])
def test_wall_pile(dev, count, wall):
    """One cell of a boundary plane holds the pile, the clamp's coordinate
    on the wall's axis, beside 4 particles a cell elsewhere."""
    cfg = _shape_cfg((20, 12, 40))
    rng = np.random.default_rng(count + wall[0])
    cell = [10, 6, 20]
    cell[wall[0]] = 0 if wall[1] == 0 else _cells(cfg)[wall[0]] - 1
    pos = np.concatenate([_uniform(cfg, rng, 4), _pile(cfg, rng, cell, count, wall)])
    pcs, vels, start = _indexed(dev, cfg, pos, count)
    assert _densest(start) >= count
    _held(cfg, pcs, vels, start)


def test_a_tile_whose_only_particles_are_one_dense_cell(dev):
    """2,000 particles in one cell and none elsewhere: 27 faces walk them
    all, every other face of the tile nothing."""
    cfg = _shape_cfg((16, 16, 64))
    rng = np.random.default_rng(7)
    pcs, vels, start = _indexed(dev, cfg, _pile(cfg, rng, (5, 9, 40), 2000), 7)
    got = _held(cfg, pcs, vels, start)
    for _, amt in got:
        assert int((amt > 0).sum()) > 0


@pytest.mark.parametrize("edge", [False, True], ids=["inside", "upper_edges"])
def test_dense_rows_across_chunks(dev, edge):
    """A row of 24 cells along z with 150 particles each (3,600 in one halo
    column), beside a second row one column over: more than a chunk of halo
    positions holds, so the chunks' ends cut runs and their pieces. On the
    grid's upper edges the last face layers take pieces too."""
    cfg = _shape_cfg((12, 16, 48))
    rng = np.random.default_rng(11 + edge)
    i, j = (cfg.nx - 1, cfg.ny - 1) if edge else (5, 6)
    z = range(cfg.nz - 24, cfg.nz) if edge else range(10, 34)
    rows = [_pile(cfg, rng, (i, j, k), 150) for k in z]
    rows += [_pile(cfg, rng, (i, j - 1, k), 90) for k in z]
    pos = np.concatenate([_uniform(cfg, rng, 2), *rows])
    pcs, vels, start = _indexed(dev, cfg, pos, 11)
    _held(cfg, pcs, vels, start)


@pytest.mark.parametrize("shape", [(13, 9, 17), (8, 8, 200)], ids=lambda s: "x".join(map(str, s)))
def test_ragged_shapes_with_a_corner_pile(dev, shape):
    """Tiles cut by the grid's edges, a pile of 1,500 in the upper corner
    cell and 300 in a cell inside, 6 particles a cell elsewhere."""
    cfg = _shape_cfg(shape)
    rng = np.random.default_rng(sum(shape))
    corner = [n - 1 for n in shape]
    inside = [n // 2 for n in shape]
    pos = np.concatenate([_uniform(cfg, rng, 6), _pile(cfg, rng, corner, 1500),
                          _pile(cfg, rng, inside, 300)])
    pcs, vels, start = _indexed(dev, cfg, pos, sum(shape))
    _held(cfg, pcs, vels, start)


def test_non_finite_positions_are_never_read(dev):
    """NaN and infinite positions (with NaN velocities) go past
    start[ncell]: the faces are the bits of the finite particles alone."""
    cfg = _shape_cfg((20, 12, 24))
    rng = np.random.default_rng(5)
    good = np.concatenate([_uniform(cfg, rng, 5), _pile(cfg, rng, (0, 3, 4), 1235, (0, 0))])
    bad = _uniform(cfg, rng, 0.05)
    bad[0::3, 0] = np.nan
    bad[1::3, 1] = np.inf
    bad[2::3, 2] = -np.inf
    pcs, vels, start = _indexed(dev, cfg, np.concatenate([good, bad]), 5)
    n = int(start[-1])
    assert n == len(good) and pcs.shape[0] > n
    vels[n:] = float("nan")
    got = _held(cfg, pcs, vels, start)
    alone = cuda_p2g.p2g_accumulate(cfg, pcs[:n].contiguous(), vels[:n].contiguous(), start)
    assert _p2g_equal(got, alone)


def _reach(mask):
    """Faces of U, V, W (each indexed like its grid) whose cells i-1 .. i+1
    on every axis meet a cell of ``mask`` (nx, ny, nz): a superset of every
    face's window."""
    nx, ny, nz = mask.shape
    grown = F.pad(mask.float()[None, None], (0, 1, 0, 1, 0, 1))
    near = F.max_pool3d(grown, 3, stride=1, padding=1)[0, 0] > 0
    return near[:, :ny, :nz], near[:nx, :, :nz], near[:nx, :ny, :]


def test_a_faces_bits_depend_on_its_window_alone(dev):
    """16 particles a cell, so that a tile's halo spans several chunks;
    then the particles of three cells removed and a pile of 700 added in
    another, which moves every later halo position and chunk boundary of
    the tiles around them. Every face whose window holds none of those
    cells keeps its bits; the faces next to them change."""
    cfg = _shape_cfg((6, 16, 64))
    rng = np.random.default_rng(3)
    pos = _uniform(cfg, rng, 16)
    vel = rng.standard_normal(pos.shape).astype(np.float32)
    cells = np.floor(pos * _cells(cfg) + 0.5).astype(np.int64)
    gone = [(2, 3, 10), (2, 4, 40), (3, 12, 33)]
    keep = np.ones(len(pos), dtype=bool)
    for c in gone:
        keep &= ~(cells == c).all(axis=1)
    added = (3, 7, 20)
    pile = _pile(cfg, rng, added, 700)
    moved = np.concatenate([pos[keep], pile])
    moved_vel = np.concatenate([vel[keep], rng.standard_normal(pile.shape).astype(np.float32)])
    before = cuda_p2g.p2g_accumulate(cfg, *_indexed(dev, cfg, pos, vel=vel))
    after = cuda_p2g.p2g_accumulate(cfg, *_indexed(dev, cfg, moved, vel=moved_vel))
    touched = torch.zeros((cfg.nx, cfg.ny, cfg.nz), dtype=torch.bool, device=dev)
    for c in [*gone, added]:
        touched[c] = True
    for (b_acc, b_amt), (a_acc, a_amt), near in zip(before, after, _reach(touched)):
        far = ~near
        assert torch.equal(b_acc[far], a_acc[far]) and torch.equal(b_amt[far], a_amt[far])
        assert not torch.equal(b_amt[near], a_amt[near])


def _window_visits(cfg, start) -> int:
    """Particle visits of every face's 27-cell window: each cell's
    particles times the cells of the grid within one cell of it."""
    counts = (start[1:] - start[:-1]).reshape(cfg.nx, cfg.ny, cfg.nz).double()
    ones = torch.ones_like(counts)[None, None]
    around = F.avg_pool3d(ones, 3, stride=1, padding=1, count_include_pad=True)[0, 0] * 27
    return int((counts * around).sum().round())


def test_counters_count_the_walk(dev):
    """A recording's step gets p2g.visits, the windows' particle visits,
    and p2g.lane_steps, a multiple of 256 no less than them; a launch with
    no recording open counts nothing and gives the same bits."""
    cfg = _shape_cfg((20, 12, 40))
    rng = np.random.default_rng(9)
    pos = np.concatenate([_uniform(cfg, rng, 8), _pile(cfg, rng, (0, 6, 20), 3000, (0, 0))])
    pcs, vels, start = _indexed(dev, cfg, pos, 9)
    plain = cuda_p2g.p2g_accumulate(cfg, pcs, vels, start)
    with trace.recording() as rec:
        with trace.span("step"):
            counted = cuda_p2g.p2g_accumulate(cfg, pcs, vels, start)
        assert rec.counts == {}
    assert _p2g_equal(plain, counted)
    visits, lane_steps = rec.counts[0]["p2g.visits"], rec.counts[0]["p2g.lane_steps"]
    assert visits == _window_visits(cfg, start)
    assert lane_steps % 256 == 0 and lane_steps >= visits
    assert trace.device_counts(cuda_p2g.COUNTERS, dev) is None
