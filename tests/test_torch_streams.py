"""Sorted sample streams at the edges of the row-tile accumulates B2
(``csrc/scatter_combine_cm.cu``) and B7 (``csrc/scatter_combine.cu``),
and tap-deposit streams at the edges of B6 (``csrc/tap_serve_cm.cu``).

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

B6 sorts the T * M deposit keys rows + delta_t and sums them in tiles of
``TILE_ROWS`` output rows; row r takes key r's deposits (d = 0) and key
r - 1's (d = 1).  Its streams carry: a key on the last row of a tile
(its d = 1 half lands in the next tile), halves of exactly 2 x CHUNK and
2 x CHUNK + 1 deposits and rows whose two halves total those, a tile
span larger than the stage, hundreds of empty tiles, keys 0 and
n_rows - 2, a sentinel pile of tens of thousands of deposits, and a
dense stream; each for the x call's 8 taps and the z/y call's 16.

The serves B1 (``csrc/window_gather_cm.cu``) and B5
(``csrc/tap_serve_cm.cu``) read a pack at the sorted rows.  B1 serves
tiles of ``TILE`` samples, each from a shared-memory copy of its window
[rows[first], rows[last] + 1] (widened to 16-byte chunks) when that fits
the stage, else from device memory; its streams carry dense tiles, tiles
whose window is exactly the stage, one chunk wider, or exactly the
stage once its ends are widened, sparse tiles, a sentinel pile on the
pack's zero tail, a sample count that is a multiple of neither the tile
nor 4, and rows at Rp - 2; for C = 1 (no unrolled instance), 10 and 16.
B5 serves every tap of a sample in one thread; its streams carry the
same rows and deltas at both ends of the tap envelope
(``sorted_cm.tap_bounds``), the y taps' jumps of whole z strides among
them, for the x call's 8 taps (envelope (4, 5)), the z/y call's 16 and
3 taps (no unrolled instance).
"""
import numpy as np
import pytest
import torch

from fgs_nerf_tpu_torch.ops import sorted_cm as ST
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B6
from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

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
B6_CASES = ("tile_edge", "two_chunks", "over_stage", "empty_tiles", "edges",
            "sentinels", "dense")
B6_TAPS = (8, 16)  # the fine stage's x and z/y tap calls
assert B6.CHUNK == B2.CHUNK
B6_STAGE = B6.STAGE_DEPOSITS  # the most deposits a B6 pass stages
# every B6 stream: 300 tiles and 3 rows, 60,000 deposits (T * M for T = 8
# and 16), the deposits its edges leave in a dense band from tile 20 on
B6_ROWS = 300 * B6.TILE_ROWS + 3
B6_DEPOSITS = 60000
B6_BAND = 20 * B6.TILE_ROWS


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


def _b6_key_counts(case, rng):
    """{key: run length} of the edges of the B6 stream ``case``."""
    tile, last = B6.TILE_ROWS, B6_ROWS - 2  # key last: d = 1 lands in R - 1
    if case == "tile_edge":
        # the last key of a tile and the first of the next, short and long
        out = {}
        for k, n in enumerate((3, 700, 40, LONG + 1)):
            out[(k + 1) * tile - 1] = n
            out[(k + 1) * tile] = 3 + k
        return out
    if case == "two_chunks":
        # halves of 2 x CHUNK and 2 x CHUNK + 1 deposits (row 4: both
        # halves 2 x CHUNK; row 10: a d = 1 half of 2 x CHUNK + 1) and rows
        # whose halves total 2 x CHUNK (41) and 2 x CHUNK + 1 (61)
        return {3: LONG, 4: LONG, 9: LONG + 1, 10: LONG, 11: 1,
                40: B6.CHUNK, 41: B6.CHUNK, 60: B6.CHUNK, 61: B6.CHUNK + 1}
    if case == "over_stage":
        # 50 keys in one tile, ~16,000 deposits: more than a stage holds
        return {r: (400 if r % 2 else 420 + 7 * r) for r in range(8, 58)}
    if case == "empty_tiles":
        return {1: 3, 2: 1, last - 1: 2, last: 4}
    if case == "edges":
        return {0: 3, 1: 1, last // 2: 9, last - 1: 2, last: 10000}
    if case == "sentinels":
        # real deposits below the band, and the pile of masked samples on
        # the three keys of the backward sentinel row (delta in -2..0)
        real = rng.choice(B6_BAND - 3, size=400, replace=False)
        out = {int(r): int(k) for r, k in zip(real, rng.integers(1, 6, 400))}
        out.update({last - 2: 9000, last - 1: 24000, last: 7000})
        return out
    return {}  # dense: the band alone


def b6_stream(case, taps, seed=0):
    """(rows int32 [M], delta int32 [T, M], w8t f32 [8T, M], g f32 [T, M],
    n_rows) with T * M = B6_DEPOSITS and n_rows = B6_ROWS (one shape per
    tap count).  The deposit keys rows + delta_t take the run lengths of
    ``case``'s edges and, for the deposits left, a dense band of runs of 0
    to 3 from row B6_BAND on; they are spread over the (t, m) slots at
    random (so runs mix taps) and the base rows are sorted."""
    rng = np.random.default_rng(seed)
    counts = _b6_key_counts(case, rng)
    left = B6_DEPOSITS - sum(counts.values())
    band = rng.integers(0, 4, size=B6_ROWS - B6_BAND)
    for key in counts:  # keep the band 3 rows from every edge key
        band[max(0, key - 2 - B6_BAND):max(0, key + 3 - B6_BAND)] = 0
    n_band = np.minimum(band, np.maximum(0, left - np.cumsum(band) + band))
    counts.update({B6_BAND + int(r): int(n_band[r])
                   for r in np.flatnonzero(n_band)})
    keys = _rows_of(counts)
    m = keys.size // taps
    keys = keys[rng.permutation(keys.size)].reshape(taps, m)
    rows = np.sort(rng.integers(0, B6_ROWS - 1, size=m))
    delta = keys - rows[None, :]
    w8t = rng.uniform(size=(8 * taps, m)).astype(np.float32)
    g = rng.normal(size=(taps, m)).astype(np.float32)
    return rows.astype(np.int32), delta.astype(np.int32), w8t, g, B6_ROWS


def b6_keys(rows, delta):
    """The sorted deposit keys rows + delta_t of a B6 stream."""
    return np.sort((rows[None, :].astype(np.int64) + delta).reshape(-1))


def b2_short_rows(rows, n_rows):
    """Rows of [0, R) whose dz = 0 run and dz = 1 run (the row below's)
    both have at most 2 x CHUNK samples: summed in sample order.  The
    same for B6 on its sorted deposit keys (d = 0 / d = 1 halves)."""
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


@pytest.mark.parametrize("taps", B6_TAPS)
@pytest.mark.parametrize("case", B6_CASES)
def test_b6_streams_are_in_range(case, taps):
    rows, delta, w8t, g, r = b6_stream(case, taps)
    m = rows.size
    assert rows.dtype == delta.dtype == np.int32 and np.all(np.diff(rows) >= 0)
    assert delta.shape == (taps, m) and g.shape == (taps, m)
    assert w8t.shape == (8 * taps, m)
    keys = b6_keys(rows, delta)
    assert keys.min() >= 0 and keys.max() <= r - 2
    assert keys.size == B6_DEPOSITS and r == B6_ROWS
    # the output rows are no multiple of 4: the padded row stride's path
    assert r % 4 != 0


@pytest.mark.parametrize("taps", B6_TAPS)
def test_b6_streams_reach_their_edges(taps):
    tile = B6.TILE_ROWS

    def stream(case):
        rows, delta, _, _, r = b6_stream(case, taps)
        keys = b6_keys(rows, delta)
        return keys, r, np.bincount(keys, minlength=r)

    def tile_spans(keys, r):  # deposits of the keys [row0 - 1, row0 + tile)
        return _tile_spans(keys, r, tile, 1)

    keys, r, counts = stream("tile_edge")
    ends = np.arange(1, 5) * tile - 1
    # a key on a tile's last row whose d = 1 half lands in the next tile,
    # with a short and a long run
    assert counts[ends].max() > LONG and counts[ends].min() > 0
    assert counts[ends + 1].min() > 0
    keys, r, counts = stream("two_chunks")
    halves = np.stack([counts[:r], np.concatenate([[0], counts[:r - 1]])])
    assert {LONG, LONG + 1} <= set(counts.tolist())
    both_short = halves.max(0) <= LONG
    totals = set(halves.sum(0)[both_short].tolist())
    assert {LONG, LONG + 1, 2 * LONG} <= totals
    assert (halves[1] == LONG + 1).any()  # a long d = 1 half
    keys, r, _ = stream("over_stage")
    assert tile_spans(keys, r).max() > B6_STAGE
    keys, r, _ = stream("empty_tiles")
    empty = np.flatnonzero(tile_spans(keys, r) == 0)
    stretches = np.split(empty, np.flatnonzero(np.diff(empty) != 1) + 1)
    assert max(map(len, stretches)) >= 200  # in a row
    keys, r, counts = stream("edges")
    assert keys[0] == 0 and keys[-1] == r - 2
    assert counts[r - 2] > B6_STAGE  # a row read from device memory
    keys, r, counts = stream("sentinels")
    assert np.sort(counts)[-3:].sum() >= 40000 and counts.max() > 20000
    keys, r, counts = stream("dense")
    band = counts[B6_BAND:keys.max() + 1]
    assert keys.min() == B6_BAND and 1.2 < band.mean() < 1.8
    assert band.max() == 3


# ---------------------------------------------------------------------------
# The serves B1 and B5
# ---------------------------------------------------------------------------

SERVE_CASES = ("dense", "stage_edges", "sparse", "sentinels", "ragged",
               "last_rows")
B1_CHANNELS = (1, 10, 16)
B1_RP = 40 * 512  # pack columns, a multiple of 512 as the port's packs
B1_REAL = B1_RP - 512  # columns from here on are the pack's zero tail
# stage_edges: (first, last) rows of tiles 0-3 relative to a 4-aligned
# base, and whether the tile is staged: a window of exactly the stage, one
# 16-byte chunk wider, the stage again once an unaligned first row is
# widened down, and one chunk wider from an unaligned first row
_EDGE_TILES = ((0, -2, True), (0, -1, False), (3, -2, True), (1, -1, False))


def _sorted_between(rng, first, last, n):
    """n sorted rows: first, n - 2 uniform in [first, last], last."""
    mid = rng.integers(first, last + 1, size=n - 2)
    return np.sort(np.concatenate([[first], mid, [last]]))


def _serve_rows(case, cols, real, rng):
    """Sorted int64 rows of a serve stream (the caller's sentinel row is
    ``real``; last_rows reaches ``real + 510``), with B1's tile edges at a
    stage of ``cols`` columns."""
    tile = B1.TILE
    if case == "dense":
        # ~5 samples a row: every window well inside any stage
        return np.sort(rng.integers(100, 100 + 400, size=8 * tile))
    if case == "stage_edges":
        parts = []
        for k, (f, l, _) in enumerate(_EDGE_TILES):
            base = 64 + k * (cols + 64)
            parts.append(_sorted_between(rng, base + f, base + cols + l, tile))
        base = 64 + 4 * (cols + 64)
        parts.append(np.sort(rng.integers(base, base + 20, size=100)))
        return np.concatenate(parts)
    if case == "sparse":
        return np.sort(rng.integers(0, real - 1, size=3 * tile))
    if case == "sentinels":
        # one dense tile of real rows, then 3.5 tiles on the sentinel row
        dense = np.sort(rng.integers(real - 300, real - 1, size=tile))
        return np.concatenate([dense, np.full(7 * tile // 2, real)])
    if case == "ragged":
        return np.sort(rng.integers(1000, 3000, size=5 * tile + 7))
    # last_rows: rows up to Rp - 2, whose column + 1 is the last one
    return np.concatenate([np.sort(rng.integers(real, real + 400, size=300)),
                           np.full(300, real + 510)])


def b1_stream(case, c, seed=0):
    """(pack f32 [4C, B1_RP], zero from B1_REAL on; rows int32 [M] sorted
    in [0, B1_RP - 2]; w8 f32 [8, M])."""
    rng = np.random.default_rng(seed)
    rows = _serve_rows(case, B1.stage_cols(c), B1_REAL, rng)
    if case == "last_rows":
        rows = np.minimum(rows, B1_RP - 2)
    pack = rng.normal(size=(4 * c, B1_RP)).astype(np.float32)
    pack[:, B1_REAL:] = 0.0
    w8 = rng.uniform(size=(8, rows.size)).astype(np.float32)
    return pack, rows.astype(np.int32), w8


def b5_envelope(taps):
    """(grid, maxneg, maxpos) of a tap call: the x call's (4, 5), else the
    z/y envelope of a 20 x 21 x 22 grid (z stride 128)."""
    grid = (20, 21, 22)
    return (grid, 4, 5) if taps == 8 else (grid, *ST.tap_bounds(grid))


def _tap_deltas(taps, m, maxneg, maxpos, zp, rng):
    """[T, M] deltas in [-maxneg, maxpos]: z-like taps of a few rows and,
    for the z/y envelope, y-like taps (odd t) of -2..1 whole z strides
    plus a few rows; every 7th sample of every tap at -maxneg, the next
    but two at maxpos, and (z/y) two more at -zp and +zp."""
    delta = rng.integers(-min(maxneg, 3), min(maxpos, 3) + 1, size=(taps, m))
    if maxneg > zp:
        jumps = rng.integers(-2, 2, size=(taps, m)) * zp
        delta = np.where(np.arange(taps)[:, None] % 2 == 1, delta + jumps,
                         delta)
    delta = np.clip(delta, -maxneg, maxpos)
    delta[:, ::7] = -maxneg
    delta[:, 3::7] = maxpos
    if maxneg > zp:
        delta[:, 5::7] = zp
        delta[:, 6::7] = -zp
    return delta


def b5_stream(case, taps, seed=0):
    """(pack f32 [4, Rp], rows int32 [M] sorted, delta int32 [T, M],
    w8t f32 [8T, M], maxneg, maxpos) in the margined tap row space of
    ``sorted_cm._tap_geometry``: real rows from ``margin`` on, the pack
    zero outside them, the sentinel row past them; every rows + delta (+ 1)
    inside the pack."""
    rng = np.random.default_rng(seed)
    grid, maxneg, maxpos = b5_envelope(taps)
    r, margin, rp, sentinel = ST._tap_geometry(grid, maxneg, maxpos)
    if case == "last_rows":  # the last real rows, then the sentinel row
        rows = np.concatenate([np.sort(rng.integers(r - 400, r, size=300)),
                               np.full(300, sentinel - margin)])
    else:
        rows = _serve_rows(case, B1.stage_cols(16), r - 2, rng)
        rows = np.where(rows >= r - 2, sentinel - margin, rows)
    rows = rows + margin
    m = rows.size
    delta = _tap_deltas(taps, m, maxneg, maxpos, ST.z_stride(grid[2]), rng)
    if case == "last_rows":  # sentinel + maxpos = Rp - 2
        delta[:, rows == sentinel] = maxpos
    pack = np.zeros((4, rp), np.float32)
    pack[:, margin:margin + r] = rng.normal(size=(4, r))
    w8t = rng.uniform(size=(8 * taps, m)).astype(np.float32)
    return (pack, rows.astype(np.int32), delta.astype(np.int32), w8t, maxneg,
            maxpos)


def b1_staged(rows, c):
    """Whether each B1 tile of the stream takes the staged branch."""
    return B1.staged_tiles(torch.from_numpy(rows), c).numpy()


@pytest.mark.parametrize("c", B1_CHANNELS)
@pytest.mark.parametrize("case", SERVE_CASES)
def test_b1_streams_are_sorted_and_in_range(case, c):
    pack, rows, w8 = b1_stream(case, c)
    assert pack.shape == (4 * c, B1_RP) and not pack[:, B1_REAL:].any()
    assert rows.dtype == np.int32 and np.all(np.diff(rows) >= 0)
    assert rows.min() >= 0 and rows.max() <= B1_RP - 2
    assert w8.shape == (8, rows.size)


@pytest.mark.parametrize("c", B1_CHANNELS)
def test_b1_streams_reach_their_branches(c):
    tile, cols = B1.TILE, B1.stage_cols(c)
    assert all(b1_staged(b1_stream("dense", c)[1], c))
    rows = b1_stream("stage_edges", c)[1]
    windows = B1.tile_windows(torch.from_numpy(rows)).numpy()
    # tiles 0 and 2 exactly at the stage, 1 and 3 one 16-byte chunk over
    assert windows[:4].tolist() == [cols, cols + 4, cols, cols + 4]
    assert b1_staged(rows, c).tolist() == [t[2] for t in _EDGE_TILES] + [True]
    # the raw span of tile 1 crosses the stage by one column
    assert rows[2 * tile - 1] + 2 - rows[tile] == cols + 1
    assert not any(b1_staged(b1_stream("sparse", c)[1], c))
    rows = b1_stream("sentinels", c)[1]
    assert (rows == B1_REAL).sum() == 7 * tile // 2
    assert all(b1_staged(rows, c)[1:])
    m = b1_stream("ragged", c)[1].size
    assert m % tile and m % 4
    rows = b1_stream("last_rows", c)[1]
    assert rows.max() == B1_RP - 2 and (rows == B1_RP - 2).sum() >= tile


@pytest.mark.parametrize("taps", (3, 8, 16))
@pytest.mark.parametrize("case", SERVE_CASES)
def test_b5_streams_are_sorted_and_in_range(case, taps):
    pack, rows, delta, w8t, maxneg, maxpos = b5_stream(case, taps)
    grid, _, _ = b5_envelope(taps)
    r, margin, rp, sentinel = ST._tap_geometry(grid, maxneg, maxpos)
    m = rows.size
    assert pack.shape == (4, rp) and delta.shape == (taps, m)
    assert w8t.shape == (8 * taps, m)
    assert rows.dtype == delta.dtype == np.int32 and np.all(np.diff(rows) >= 0)
    assert np.all((rows >= margin) & (rows < margin + r) | (rows == sentinel))
    assert delta.min() >= -maxneg and delta.max() <= maxpos
    cols = rows[None, :].astype(np.int64) + delta
    assert cols.min() >= 0 and cols.max() + 1 <= rp - 1


@pytest.mark.parametrize("taps", (3, 8, 16))
def test_b5_streams_reach_their_edges(taps):
    grid, maxneg, maxpos = b5_envelope(taps)
    _, _, rp, sentinel = ST._tap_geometry(grid, maxneg, maxpos)
    zp = ST.z_stride(grid[2])
    _, rows, delta, _, _, _ = b5_stream("dense", taps)
    # both ends of the envelope in every tap
    assert (delta.min(1) == -maxneg).all() and (delta.max(1) == maxpos).all()
    if taps != 8:  # y taps: whole z strides either way
        assert {-2 * zp, -zp, zp}.issubset(set(np.unique(delta).tolist()))
    rows = b5_stream("sentinels", taps)[1]
    assert (rows == sentinel).sum() == 7 * B1.TILE // 2
    m = b5_stream("ragged", taps)[1].size
    assert m % 256 and m % 4
    _, rows, delta, _, _, _ = b5_stream("last_rows", taps)
    assert (rows[None, :] + delta).max() == rp - 2
