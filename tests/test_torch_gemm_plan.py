"""The launch plans of the bf16 ``gemm`` and ``gmm`` kernels (the TMA +
wgmma mainloop of ``csrc/hopper_gemm.cuh``) on the CPU, where the kernels
cannot run. The Python mirrors (``kernels/gemm.py`` ``gemm_plan``,
``gemm_units``, ``raster``, ``gemm_tile``, ``pick_bn``; ``kernels/gmm.py`` ``gmm_row_tiles``,
``gmm_plan``) are held with hypothesis:

- every output row and column is owned by exactly one tile, and the
  persistent grid's clusters (gemm) or blocks (gmm) visit every tile
  exactly once;
- no ``gmm`` tile stores rows of two groups, and every tile stores a row;
- the row tiles fit the grid's bound ``ceil(M / 128) + G``;
- the plans depend on the shapes alone, never on the group sizes.
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from pygpukit_tpu_torch.kernels.gemm import (CLUSTERS, H100_SMS, RASTER_ROWS, TILE_M,
                                             TILE_NS, gemm_plan, gemm_tile, gemm_units, pick_bn,
                                             raster)
from pygpukit_tpu_torch.kernels.gmm import gmm_plan, gmm_row_tiles

_SMS = st.sampled_from([H100_SMS, 114, 1, 7])


def _visits(tiles: int, grid: int) -> list[int]:
    """Tiles in the order the persistent blocks take them: block b walks
    b, b + grid, b + 2 grid, ..."""
    return [t for b in range(grid) for t in range(b, tiles, grid)]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 9000), n=st.integers(1, 20000),
       clusters=st.sampled_from([{256: 66, 128: 33}, {256: 64, 128: 30}, {256: 1, 128: 1},
                                 {256: 7, 128: 3}]))
def test_gemm_plan_owns_every_element_once(m, n, clusters):
    """Each cluster walks its units in order, each CTA of it one tile of the
    unit: every row tile and column tile is computed exactly once, and the
    rows and columns they store cover [0, m) x [0, n) once; the width is
    the one whose waves of units cost least."""
    plan = gemm_plan(m, n, clusters)
    bn, (cm, cn) = plan["bn"], plan["cluster"]
    cost = {w: -(-(gemm_units(m, n, w)[0] * gemm_units(m, n, w)[1]) // clusters[w]) * w
            for w in TILE_NS}
    assert cost[bn] == min(cost.values()) and (bn == 256 or cost[128] < cost[256])
    assert (cm, cn) == CLUSTERS[bn] and plan["units"] == plan["units_m"] * plan["units_n"]
    assert 0 <= plan["units_m"] * cm - -(-m // TILE_M) < cm
    assert 0 <= plan["units_n"] * cn - -(-n // bn) < cn
    size = cm * cn
    assert plan["grid"] % size == 0
    assert 1 <= plan["grid"] // size <= min(plan["units"], clusters[bn])
    assert plan["waves"] * clusters[bn] >= plan["units"] > (plan["waves"] - 1) * clusters[bn]
    order = _visits(plan["units"], plan["grid"] // size)
    assert sorted(order) == list(range(plan["units"]))
    coords = [gemm_tile(u, rank, plan) for u in order for rank in range(size)]
    rows_t, cols_t = plan["units_m"] * cm, plan["units_n"] * cn
    assert sorted(coords) == [(i, j) for i in range(rows_t) for j in range(cols_t)]
    rows = np.zeros(m, np.int64)
    cols = np.zeros(n, np.int64)
    for i in range(rows_t):
        rows[i * TILE_M:(i + 1) * TILE_M] += 1
    for j in range(cols_t):
        cols[j * bn:(j + 1) * bn] += 1
    assert (rows == 1).all() and (cols == 1).all()


@settings(max_examples=300, deadline=None)
@given(row_tiles=st.integers(1, 400), n=st.integers(1, 20000), sms=_SMS)
def test_pick_bn_takes_the_fewest_wasted_slots(row_tiles, n, sms):
    """gmm's width: the one whose waves cost least (waves x width); 256 on
    a tie."""
    cost = {bn: -(-row_tiles * -(-n // bn) // sms) * bn for bn in TILE_NS}
    bn = pick_bn(row_tiles, n, sms)
    assert cost[bn] == min(cost.values())
    assert bn == 256 or cost[128] < cost[256]


@settings(max_examples=200, deadline=None)
@given(tiles_m=st.integers(1, 100), tiles_n=st.integers(1, 60))
def test_raster_sweeps_groups_of_row_tiles(tiles_m, tiles_n):
    """Row tiles vary fastest inside a group of RASTER_ROWS; a group is
    swept column by column before the next begins."""
    coords = [raster(t, tiles_m, tiles_n) for t in range(tiles_m * tiles_n)]
    groups = [tm // RASTER_ROWS for tm, _ in coords]
    assert groups == sorted(groups)
    for t in range(1, len(coords)):
        (pm, pn), (cm, cn) = coords[t - 1], coords[t]
        if groups[t] == groups[t - 1]:
            assert (cn, cm) > (pn, pm)


def test_gemm_plan_at_the_projection_shapes():
    """The 1.1B projections at M 2048 on the H100's 66 pairs (256-wide
    tiles) or 33 clusters of 2 x 2 (128-wide): qkv and gate_up take the
    128-wide tile (fewer wasted slots), o and down the 256-wide."""
    got = {name: gemm_plan(2048, n)["bn"]
           for name, n in (("qkv", 2560), ("o", 2048), ("gate_up", 11264), ("down", 2048))}
    assert got == {"qkv": 128, "o": 256, "gate_up": 128, "down": 256}
    assert gemm_plan(8192, 8192) == {"bn": 256, "cluster": (2, 1), "units_m": 32,
                                     "units_n": 32, "units": 1024, "grid": 132, "waves": 16}


@st.composite
def _groups(draw):
    g = draw(st.integers(1, 160))
    sizes = draw(st.lists(st.one_of(st.just(0), st.integers(0, 9), st.integers(0, 400)),
                          min_size=g, max_size=g))
    total = sum(sizes)
    m = draw(st.one_of(st.just(max(total, 1)), st.integers(1, total + 300)))
    return sizes, m


@settings(max_examples=300, deadline=None)
@given(case=_groups(), n=st.integers(1, 600).map(lambda x: x * 8), sms=_SMS)
def test_gmm_tiles_own_every_row_once_within_one_group(case, n, sms):
    sizes, m = case
    g = len(sizes)
    tiles = gmm_row_tiles(sizes, m)
    plan = gmm_plan(m, n, g, sms)
    assert len(tiles) <= plan["row_bound"] == -(-m // TILE_M) + g
    assert 1 <= plan["grid"] <= min(plan["row_bound"] * plan["tiles_n"], sms)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    seg_of_row = np.searchsorted(offs, np.arange(m), side="right") - 1   # g for rows past the sum
    owned = np.zeros(m, np.int64)
    for seg, lo, hi, m0 in tiles:
        stored = np.arange(max(lo, m0), min(hi, m0 + TILE_M))
        assert stored.size > 0                         # no tile without a row to store
        assert m0 == lo + (m0 - lo) // TILE_M * TILE_M  # tiles start at the segment's first row
        assert (seg_of_row[stored] == seg).all()       # rows of one group (or the rows past it)
        owned[stored] += 1
    assert (owned == 1).all()
    # the blocks visit every (row tile, column tile) exactly once
    total = len(tiles) * plan["tiles_n"]
    order = _visits(total, plan["grid"])
    coords = sorted(raster(t, len(tiles), plan["tiles_n"]) for t in order)
    assert coords == [(i, j) for i in range(len(tiles)) for j in range(plan["tiles_n"])]


@settings(max_examples=100, deadline=None)
@given(a=_groups(), seed=st.integers(0, 2 ** 31 - 1))
def test_gmm_plan_depends_on_shapes_alone(a, seed):
    """The plan takes (M, N, G) only, so the grid a CUDA graph captures for
    one set of group sizes must hold every other set of the same G over the
    same M: their row tiles fit its bound."""
    sizes, m = a
    other = np.random.default_rng(seed).multinomial(m, np.ones(len(sizes)) / len(sizes))
    plan = gmm_plan(m, 768, len(sizes))
    for s in (sizes, other.tolist(), [m] + [0] * (len(sizes) - 1), [0] * len(sizes)):
        tiles = gmm_row_tiles(s, m)
        assert len(tiles) <= plan["row_bound"]
        assert sum(min(hi, m0 + TILE_M) - m0 for _, lo, hi, m0 in tiles) == m


def test_gmm_tiles_start_at_group_starts():
    """A group that starts mid-way through a 128-row span gets its own
    tiles (megablox's aligned tiles would straddle it); the rows past the
    sum form the last segment."""
    tiles = gmm_row_tiles([60, 200, 0, 10], 300)
    assert tiles == [(0, 0, 60, 0), (1, 60, 260, 60), (1, 60, 260, 188),
                     (3, 260, 270, 260), (4, 270, 300, 270)]
    assert gmm_row_tiles([5, 5], 4) == [(0, 0, 4, 0)]            # sizes past M are clamped
