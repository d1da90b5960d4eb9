"""Sorted sample streams at the edges of the row-tile accumulates B2
(``csrc/scatter_combine_cm.cu``) and B7 (``csrc/scatter_combine.cu``).

One JAX-free place for the streams: the card tests
(``tests/test_torch_kernels.py``) hold the kernels against their plain
twins on them, and the CPU parity tests (``test_torch_sorted_serve.py``,
``test_torch_lattice_ops.py``) hold the twins against the JAX package on
the same streams, so kernel = twin = JAX on each.  The tests here check
that every stream has the edge its name promises, at the tile sizes the
kernels choose for it.

Edges: a run on the last row of a tile (B2 deposits its dz = 1 half in
the next tile's first row), runs of exactly 2 x CHUNK and 2 x CHUNK + 1
samples (the last run added sample by sample, the first one through
block sums), a tile span larger than the shared-memory stage, hundreds of
empty tiles in a row, the first and last rows (B2: row R - 2, whose dz = 1
half lands in R - 1; B7: cap - 1), row spaces that are multiples of
neither the tile nor 4, one sample, fewer samples than CHUNK, and a
dense stream of short runs.
"""
import numpy as np
import pytest

from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2

CASES = ("tile_edge", "two_chunks", "over_stage", "empty_tiles", "edges",
         "one", "short", "dense")
B2_CHANNELS = (1, 10, 16)  # 10: the geometry stage's 4 + k0_dim 6
B7_CHANNELS = (1, 3, 8, 104, 128)
LONG = 2 * B2.CHUNK  # a run longer than this goes through block sums
assert B7.CHUNK == B2.CHUNK
# more samples than a pass's stage has 4-byte words, so more than any
# pass stages; a run longer than ROW_OVER_STAGE does not fit a stage on
# its own (a staged sample takes its key and at least one value)
OVER_STAGE = B2.STAGE_BYTES // 4
ROW_OVER_STAGE = B2.STAGE_BYTES // 8
assert B7.STAGE_BYTES == B2.STAGE_BYTES


def b7_tile(c):
    """Rows of a B7 tile: a multiple of 4 near TILE_FLOATS / C."""
    return max(4, B7.TILE_FLOATS // c // 4 * 4)


def _rows_of(lengths):
    """Sorted rows from {row: run length}."""
    return np.repeat(np.array(sorted(lengths), np.int64),
                     [lengths[r] for r in sorted(lengths)])


def _row_lengths(case, n_rows, tile, rng, last):
    """{row: run length} of ``case`` for a row space of ``n_rows`` rows cut
    into tiles of ``tile`` rows; ``last`` is the last row a key may take."""
    if case == "tile_edge":
        # runs on the last row of tiles and the first of the next, short
        # and long ones, at every tile size the wrappers use
        out = {}
        for k, t in enumerate((4, 64, 256, 512, 1024, tile)):
            edge = max(1, min(k + 3, last // t)) * t - 1
            if edge + 1 <= last:
                out[edge] = (300, 700)[k % 2]
                out[edge + 1] = 5 + k
        return out
    if case == "two_chunks":
        return {3: LONG, 4: LONG + 1, 9: LONG + 1, 10: LONG, 11: 1,
                40: B2.CHUNK, 41: B2.CHUNK + 1}
    if case == "over_stage":
        # 50 rows in one tile, short runs of ~400 beside long ones:
        # ~20,000 samples, more than any stage holds
        return {r: (400 if r % 2 else 420 + 7 * r) for r in range(8, 58)}
    if case == "empty_tiles":
        return {1: 3, 2: 1, last - 1: 2, last: 4}
    if case == "edges":
        return {0: 3, 1: 1, last // 2: 9, last - 1: 2, last: 10000}
    if case == "one":
        return {last // 3: 1}
    if case == "short":
        return {r: int(rng.integers(1, 4)) for r in range(5, 95, 2)}
    # dense: ~1.5 samples per row, runs of 0 to 3
    return {r: int(k) for r, k in enumerate(rng.integers(0, 4, size=last + 1))
            if k}


def b2_stream(case, c, seed=0):
    """(rows int32 [M] in [0, R - 2], w8 f32 [8, M], g f32 [C, M], R)."""
    rng = np.random.default_rng(seed)
    t = B2.TILE_ROWS
    n_rows = {"empty_tiles": 300 * t + 3, "dense": 12007,
              "tile_edge": 10 * 1024 + 5}.get(case, 5003)
    rows = _rows_of(_row_lengths(case, n_rows, t, rng, n_rows - 2))
    m = rows.size
    w8 = rng.uniform(size=(8, m)).astype(np.float32)
    g = rng.normal(size=(c, m)).astype(np.float32)
    return rows.astype(np.int32), w8, g, n_rows


def b7_stream(case, c, seed=0):
    """(rows int32 [M] in [0, cap), upd f32 [M, C], cap)."""
    rng = np.random.default_rng(seed)
    t0 = b7_tile(c)
    cap = {"empty_tiles": 300 * t0 + 3, "dense": 12007,
           "tile_edge": 11 * 1024 + 5}.get(case, 5003)
    rows = _rows_of(_row_lengths(case, cap, t0, rng, cap - 1))
    upd = rng.normal(size=(rows.size, c)).astype(np.float32)
    return rows.astype(np.int32), upd, cap


def b2_short_rows(rows, n_rows):
    """Rows of [0, R) whose dz = 0 run and dz = 1 run (the row below's)
    both have at most 2 x CHUNK samples: summed in sample order."""
    counts = np.bincount(rows, minlength=n_rows)[:n_rows]
    long_ = counts > LONG
    return ~(long_ | np.concatenate([[False], long_[:-1]]))


def b7_short_rows(rows, cap):
    return np.bincount(rows, minlength=cap)[:cap] <= LONG


def _tile_spans(rows, n_rows, tile, lead):
    """Samples per tile: rows [row0 - lead, row0 + tile)."""
    starts = np.arange(0, n_rows, tile)
    lo = np.searchsorted(rows, starts - lead, side="left")
    hi = np.searchsorted(rows, starts + tile, side="left")
    return hi - lo


def _b2_spans(case, c):
    rows, w8, g, r = b2_stream(case, c)
    return rows, r, _tile_spans(rows, r, B2.TILE_ROWS, 1)


def _b7_spans(case, c):
    rows, upd, cap = b7_stream(case, c)
    return rows, cap, _tile_spans(rows, cap, b7_tile(c), 0)


@pytest.mark.parametrize("case", CASES)
def test_streams_are_sorted_and_in_range(case):
    for c in B2_CHANNELS:
        rows, w8, g, r = b2_stream(case, c)
        assert rows.dtype == np.int32 and np.all(np.diff(rows) >= 0)
        assert rows.size >= 1 and rows.min() >= 0 and rows.max() <= r - 2
        assert w8.shape == (8, rows.size) and g.shape == (c, rows.size)
        assert r % 4 != 0
    for c in B7_CHANNELS:
        rows, upd, cap = b7_stream(case, c)
        assert np.all(np.diff(rows) >= 0) and rows.min() >= 0
        assert rows.max() <= cap - 1 and upd.shape == (rows.size, c)
        assert cap % 4 != 0 and cap % b7_tile(c)


def test_streams_reach_their_edges():
    for c in B2_CHANNELS:
        rows, r, spans = _b2_spans("over_stage", c)
        assert spans.max() > OVER_STAGE
        assert {LONG, LONG + 1} <= set(
            np.bincount(b2_stream("two_chunks", c)[0]).tolist())
        rows, r, spans = _b2_spans("empty_tiles", c)
        empty = np.flatnonzero(spans == 0)
        assert empty.size >= 200 and np.all(np.diff(empty) == 1)
        rows, r, _ = _b2_spans("edges", c)
        assert rows[0] == 0 and rows[-1] == r - 2
        counts = np.bincount(rows, minlength=r)
        assert counts[r - 2] > ROW_OVER_STAGE
        rows, r, _ = _b2_spans("tile_edge", c)
        counts = np.bincount(rows, minlength=r)
        edges = np.arange(B2.TILE_ROWS - 1, r - 1, B2.TILE_ROWS)
        assert counts[edges].max() > LONG and (counts[edges] > 0).sum() >= 1
        assert b2_stream("one", c)[0].size == 1
        assert b2_stream("short", c)[0].size < B2.CHUNK
    for c in B7_CHANNELS:
        _, _, spans = _b7_spans("over_stage", c)
        assert spans.max() > OVER_STAGE
        _, _, spans = _b7_spans("empty_tiles", c)
        empty = np.flatnonzero(spans == 0)
        assert empty.size >= 200 and np.all(np.diff(empty) == 1)
        rows, cap, _ = _b7_spans("edges", c)
        assert rows[0] == 0 and rows[-1] == cap - 1
        assert np.bincount(rows)[cap - 1] > ROW_OVER_STAGE
        assert {LONG, LONG + 1} <= set(
            np.bincount(b7_stream("two_chunks", c)[0]).tolist())
        assert b7_stream("one", c)[0].size == 1
        assert b7_stream("short", c)[0].size < B7.CHUNK
