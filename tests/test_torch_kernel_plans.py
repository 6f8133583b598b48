"""The launch plans of the stage-5.4 kernels that hold their work in
shared memory: ``ops/dense_dp_cuda.py::dense_dp_plan`` (warps and shared
memory of ``csrc/dense_dp.cu``), ``ops/traceback_cuda.py::
banded_walk_plan`` (the successor ring of ``csrc/traceback_walk.cu``) and
``dense_walk_plan`` (the ring of plane chunks there).
They are Python copies of the sources' own plans, which the wrappers
call on the card: these tests have no nvcc to build the sources, and
``chip_smoke.py`` holds the copies to the sources' plans there. Every shape the kernels took
before keeps a plan; a shape whose shared memory cannot hold the kernel
raises."""

import re
from pathlib import Path

import pytest

import chip_smoke
from svecalign_tpu_torch.ops import dense_dp_cuda, traceback_cuda

H100_SMEM_OPTIN = 232448  # shared memory a block of an H100 may opt in to
CSRC = Path(dense_dp_cuda.__file__).resolve().parent.parent / "csrc"


def _defines(name):
    src = (CSRC / f"{name}.cu").read_text()
    return {k: v for k, v in re.findall(r"^#define (\w+) (\S+)", src, re.M)}


def test_plan_constants_are_the_sources():
    dense = _defines("dense_dp")
    assert int(dense["DP_MAX_WARPS"]) == dense_dp_cuda.MAX_WARPS
    assert int(dense["DP_MAX_ROWS"]) == dense_dp_cuda.MAX_ROWS
    assert int(dense["DP_STATIC_SMEM"]) == dense_dp_cuda.STATIC_SMEM
    cost, bp, qlen = int(dense["COST_STRIDE"]), int(dense["BP_STRIDE"]), int(dense["QLEN"])
    for rows in range(1, dense_dp_cuda.MAX_ROWS + 1):
        assert dense_dp_cuda.warp_smem(rows) == rows * 2 * 32 * (cost * 4 + bp) + qlen * 8
    walk = _defines("traceback_walk")
    assert int(walk["WALK_CHUNK_SHIFT"]) == traceback_cuda.WALK_CHUNK_SHIFT
    assert int(walk["WALK_RING_BYTES"]) == traceback_cuda.WALK_RING_BYTES
    assert int(walk["WALK_MAX_SLOTS"]) == traceback_cuda.WALK_MAX_SLOTS
    assert int(walk["WALK_STATIC_SMEM"]) == traceback_cuda.WALK_STATIC_SMEM
    # a producer lane's batch covers a chunk's cells in whole batches
    assert (32 * int(walk["WALK_BATCH"])) % (1 << traceback_cuda.WALK_CHUNK_SHIFT) == 0
    assert int(walk["DWALK_CHUNK_SHIFT"]) == traceback_cuda.DWALK_CHUNK_SHIFT
    assert int(walk["DWALK_MAX_SLOTS"]) == traceback_cuda.DWALK_MAX_SLOTS
    assert int(walk["DWALK_MAX_RECORDS"]) == traceback_cuda.DWALK_MAX_RECORDS
    assert int(walk["DWALK_STATIC_SMEM"]) == traceback_cuda.DWALK_STATIC_SMEM
    # a turn's four loads reach at most 4 x 62 bytes past a cell on corrupt pointers
    assert int(walk["DWALK_GUARD"]) == traceback_cuda.DWALK_GUARD >= 4 * 62
    # a reused ring is a power of two of slots (its offsets are s & mask)
    assert traceback_cuda.DWALK_MAX_SLOTS & (traceback_cuda.DWALK_MAX_SLOTS - 1) == 0


# ---------------------------------------------------------------------------
# dense DP: strips of 32 x rows rows, a warp each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,M,rows,warps,wrap", [
    (300, 275, 2, 5, False),  # the main path at P = 1
    (176, 160, 1, 6, False),  # the main path's bucket at P = 8
    (40, 1500, 1, 2, False),
    (1, 1, 1, 1, False),
    (0, 7, 1, 1, False),  # no rows: the edges alone
    (32, 33, 1, 1, False),
    (33, 33, 1, 2, False),
    (256, 9, 1, 8, False),
    (257, 9, 2, 5, False),
    (512, 600, 2, 8, False),
    (513, 600, 2, 8, True),  # strips past the last warp: the wrap queue
])
def test_dense_dp_plan_geometry(N, M, rows, warps, wrap):
    plan = dense_dp_cuda.dense_dp_plan(N, M, H100_SMEM_OPTIN)
    assert (plan.rows, plan.warps, plan.wrap) == (rows, warps, wrap)
    assert plan.smem_bytes == warps * dense_dp_cuda.warp_smem(rows)
    assert plan.smem_bytes + dense_dp_cuda.STATIC_SMEM <= H100_SMEM_OPTIN


# (rows a lane, warps, wrap) of each DENSE_CASES bucket (N x M the largest
# pair's sides): ceil(N / 256) rows a lane up to 2, a warp per strip of
# 32 x rows rows up to 8, the strips past the eighth warp round again
DENSE_CASE_PLANS = {
    "300 x 275 (the main path's, P = 1)": (2, 5, False),  # 300 rows: 5 strips of 64
    "N < M": (1, 2, False),  # 40 rows: 2 strips of 32
    "N > M": (1, 5, False),  # 130
    "N = 1": (1, 1, False),
    "M = 1": (1, 1, False),  # 30
    "(1, 1)": (1, 1, False),
    "a side over the block's threads (1500 x 40)": (2, 8, True),  # 24 strips of 64
    "a diagonal over the block's threads (1100 x 1300)": (2, 8, True),  # 18 strips
    "P = 8, ragged sizes, distinct pens": (2, 5, False),  # 300 x 275
    "P = 3 with an empty side and a (1, 1)": (1, 1, False),  # 12
    "off the strip width, n <= m (97 x 131)": (1, 4, False),
    "off the strip width, n > m (131 x 97)": (1, 5, False),
    "one strip and one row over (33 x 200)": (1, 2, False),
    "strips past the last warp, n > m (800 x 530)": (2, 8, True),  # 13 strips
    "both orientations in one bucket": (1, 7, False),  # 200 x 200
    "empty sides, P = 3": (1, 1, False),  # 9 x 33
}


@pytest.mark.parametrize("name,sizes", chip_smoke.DENSE_CASES, ids=[c[0] for c in chip_smoke.DENSE_CASES])
def test_dense_dp_plan_admits_every_checked_bucket(name, sizes):
    N, M = max(n for n, _ in sizes), max(m for _, m in sizes)
    plan = dense_dp_cuda.dense_dp_plan(N, M, H100_SMEM_OPTIN)
    assert (plan.rows, plan.warps, plan.wrap) == DENSE_CASE_PLANS[name]
    assert plan.smem_bytes + dense_dp_cuda.STATIC_SMEM <= H100_SMEM_OPTIN


@pytest.mark.parametrize("N,M", [(19368, 19368), (19368, 40000), (40000, 3), (4000, 4000),
                                 (1100, 1300)])
def test_dense_dp_plan_admits_what_the_first_design_admitted(N, M):
    """The first design held three diagonals of min(N, M) + 2 floats, so
    it took every min(N, M) up to 19368 on an H100; the strips take any
    size, going round the warps as often as needed."""
    assert 3 * (min(N, M) + 2) * 4 <= H100_SMEM_OPTIN
    plan = dense_dp_cuda.dense_dp_plan(N, M, H100_SMEM_OPTIN)
    assert plan.rows == dense_dp_cuda.MAX_ROWS and plan.warps == dense_dp_cuda.MAX_WARPS
    assert plan.wrap


@pytest.mark.parametrize("N,M,optin", [(300, 275, 40000), (33, 40, 20000), (20, 30, 10000),
                                       (1, 1, 1024)])
def test_dense_dp_plan_refuses_what_does_not_fit(N, M, optin):
    with pytest.raises(ValueError, match="shared memory"):
        dense_dp_cuda.dense_dp_plan(N, M, optin)


def test_dense_dp_plan_one_warp_where_one_strip_fits():
    plan = dense_dp_cuda.dense_dp_plan(20, 30, 20000)
    assert plan.warps == 1 and plan.smem_bytes + dense_dp_cuda.STATIC_SMEM <= 20000


# ---------------------------------------------------------------------------
# banded walk: the successor ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a2,B,plan", [
    (2693, 16, (4, 5, 32, 65536 + 4 * 2696, 2696)),  # the main path's final level at P = 8
    (2305, 16, (4, 5, 32, 65536 + 4 * 2308, 2308)),  # and at P = 1
    (100, 16, (4, 5, 4, 8192 + 416, 104)),  # a plane smaller than the ring: its rows, rounded up
    (3, 6, (3, 6, 1, 2048 + 32, 8)),  # one chunk
    (974, 140, (8, 1, 32, 65536 + 4 * 980, 980)),  # wide band: chunks of two rows
    (212, 1200, (11, 0, 8, 65536 + 4 * 216, 216)),  # a chunk of one row
    (50, 1 << 14, (14, 0, 1, 65536 + 224, 56)),  # one ring row of 2**14 successors
    (50, 1 << 15, (15, 0, 1, 131072 + 224, 56)),  # the widest band a ring row of an H100 holds
    (40_000, 16, (4, 5, 32, 65536 + 65536, 16384)),  # records past 2**14 steps go to xs
])
def test_banded_walk_plan(a2, B, plan):
    assert tuple(traceback_cuda.banded_walk_plan(a2, B, H100_SMEM_OPTIN)) == plan


def _walk_shapes():
    """(A + 2, B) of every banded case the checks run: KERNEL_CASES' and
    WALK_CASES' planes, and offsets rows past the first design's 48 KB
    limit for them on chip (A + 2 > 12288)."""
    shapes = []
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.WALK_CASES):
        for case in cases:
            sizes, w2 = case[1], case[3]
            shapes.append((max(n + m for n, m in sizes) + 3, 2 * w2))
    return shapes + [(12290, 16), (100_002, 16), (40_000, 6), (3, 1)]


@pytest.mark.parametrize("a2,B", _walk_shapes())
def test_banded_walk_plan_admits_every_checked_shape(a2, B):
    plan = traceback_cuda.banded_walk_plan(a2, B, H100_SMEM_OPTIN)
    rows = plan.slots << plan.chunk_shift
    assert 1 << plan.row_shift >= B > 1 << plan.row_shift >> 1 or B == 1
    assert plan.slots & (plan.slots - 1) == 0 and 1 <= plan.slots <= traceback_cuda.WALK_MAX_SLOTS
    # a chunk is 2**WALK_CHUNK_SHIFT cells, or one row where a row is longer
    assert (1 << plan.chunk_shift + plan.row_shift) == max(
        1 << traceback_cuda.WALK_CHUNK_SHIFT, 1 << plan.row_shift)
    # room for the longest walk and the three steps a turn of four overruns
    assert plan.records == min((a2 + 6) & ~3, traceback_cuda.WALK_MAX_RECORDS)
    assert plan.smem_bytes == (rows * 4 << plan.row_shift) + 4 * plan.records
    assert plan.smem_bytes - 4 * plan.records <= max(traceback_cuda.WALK_RING_BYTES,
                                                     4 << plan.row_shift)
    # no larger than the plane needs, beyond one chunk
    assert rows <= max(1 << plan.chunk_shift, 1 << (a2 - 1).bit_length())


@pytest.mark.parametrize("a2,B,optin", [(50, 1 << 16, H100_SMEM_OPTIN),
                                        (50, (1 << 15) + 1, H100_SMEM_OPTIN),
                                        (2693, 16, 2000),
                                        (1 << 27, 16, H100_SMEM_OPTIN)])
def test_banded_walk_plan_refuses_what_does_not_fit(a2, B, optin):
    with pytest.raises(ValueError, match="banded_traceback_walk_cuda"):
        traceback_cuda.banded_walk_plan(a2, B, optin)


# ---------------------------------------------------------------------------
# dense walk: a ring of 4096-byte chunks of the plane
# ---------------------------------------------------------------------------


# (slots, reused, bytes, records); bytes are the ring's, the records' and a 256-byte guard
@pytest.mark.parametrize("N,M,plan", [
    # the main path's bucket at P = 8: 177 x 161 = 28,497 bytes touch at most 8 chunks
    # (28,497 bytes from offset 4095 end in chunk 7); 337 steps + 3, rounded up to 340
    (176, 160, (8, False, 8 * 4096 + 4 * 340 + 256, 340)),
    # and at P = 1: 301 x 276 = 83,076 bytes, from offset 4095 into chunk 21: 22 chunks
    (300, 275, (22, False, 22 * 4096 + 4 * 580 + 256, 580)),
    # 1101 x 1301 = 1,432,401 bytes: 351 chunks, over 32: 32 slots reused; 2401 steps
    (1100, 1300, (32, True, 32 * 4096 + 4 * 2404 + 256, 2404)),
    # 90,001 x 2 = 180,002 bytes (45 chunks): reused; 90,002 steps, records in xs
    (90000, 1, (32, True, 32 * 4096 + 256, 0)),
    # one byte: one chunk; one step, rounded up to 4
    (0, 0, (1, False, 4096 + 16 + 256, 4)),
    # 4 bytes may straddle a chunk boundary: two slots
    (1, 1, (2, False, 2 * 4096 + 4 * 8 + 256, 8)),
    # 126,977 bytes from offset 4095 end at byte 131,071, in chunk 31: 32 chunks; one byte
    # more reaches a 33rd. Both walks are over 16,384 steps: no records in shared memory
    (0, 126976, (32, False, 32 * 4096 + 256, 0)),
    (0, 126977, (32, True, 32 * 4096 + 256, 0)),
])
def test_dense_walk_plan(N, M, plan):
    assert tuple(traceback_cuda.dense_walk_plan(N, M, H100_SMEM_OPTIN)) == plan


def test_dense_walk_ring_holds_every_chunk_a_walk_touches():
    """Where the ring is not reused, its slots hold every 4096-byte chunk
    that [0, k0] of a pair's plane touches, wherever in a chunk the plane
    starts (counted chunk by chunk, for every start offset of a 16-byte
    grid and the last bytes of a chunk)."""
    for N, M in ((176, 160), (300, 275), (0, 0), (1, 1), (63, 63), (0, 4095), (0, 4096),
                 (15, 255), (123, 1022)):
        plan = traceback_cuda.dense_walk_plan(N, M, H100_SMEM_OPTIN)
        top = (N + 1) * (M + 1) - 1
        for koff in list(range(0, 4096, 16)) + list(range(4080, 4096)):
            touched = len(range(koff // 4096, (koff + top) // 4096 + 1))
            assert plan.wrap or touched <= plan.slots, (N, M, koff)
        assert plan.wrap == (max((k + top) // 4096 + 1 for k in range(4096)) > 32)


# (slots, reused) of each DENSE_CASES bucket's planes ((N + 1) x (M + 1) for
# the largest pair's sides; a plane of b bytes touches (b + 4094) // 4096 + 1
# chunks at most)
DENSE_CASE_WALK_RINGS = {
    "300 x 275 (the main path's, P = 1)": (22, False),  # 83,076 bytes
    "N < M": (2, False),  # 41 x 58 = 2378
    "N > M": (3, False),  # 131 x 32 = 4192
    "N = 1": (2, False),  # 2 x 31
    "M = 1": (2, False),  # 31 x 2
    "(1, 1)": (2, False),  # 4 bytes
    "a side over the block's threads (1500 x 40)": (17, False),  # 1501 x 41 = 61,541
    "a diagonal over the block's threads (1100 x 1300)": (32, True),  # 1,432,401
    "P = 8, ragged sizes, distinct pens": (22, False),  # 300 x 275
    "P = 3 with an empty side and a (1, 1)": (2, False),  # 13 x 10
    "off the strip width, n <= m (97 x 131)": (5, False),  # 98 x 132 = 12,936
    "off the strip width, n > m (131 x 97)": (5, False),
    "one strip and one row over (33 x 200)": (3, False),  # 34 x 201 = 6834
    "strips past the last warp, n > m (800 x 530)": (32, True),  # 425,331
    "both orientations in one bucket": (11, False),  # 201 x 201 = 40,401
    "empty sides, P = 3": (2, False),  # 10 x 34
}


@pytest.mark.parametrize("name,sizes", chip_smoke.DENSE_CASES, ids=[c[0] for c in chip_smoke.DENSE_CASES])
def test_dense_walk_plan_admits_every_checked_bucket(name, sizes):
    N, M = max(n for n, _ in sizes), max(m for _, m in sizes)
    plan = traceback_cuda.dense_walk_plan(N, M, H100_SMEM_OPTIN)
    assert (plan.slots, plan.wrap) == DENSE_CASE_WALK_RINGS[name]
    assert plan.records == (N + M + 7) & ~3  # every checked walk records in shared memory
    assert plan.smem_bytes == plan.slots * 4096 + 4 * plan.records + 256
    assert plan.smem_bytes + traceback_cuda.DWALK_STATIC_SMEM <= H100_SMEM_OPTIN


@pytest.mark.parametrize("N,M,optin", [(300, 275, 50000),  # 92,688 bytes and 1024 static
                                       (176, 160, 35000),  # 34,384 and 1024
                                       (46340, 46340, H100_SMEM_OPTIN),  # 2**31 bytes a plane
                                       (-1, 5, H100_SMEM_OPTIN)])
def test_dense_walk_plan_refuses_what_does_not_fit(N, M, optin):
    with pytest.raises(ValueError, match="dense_traceback_walk_cuda"):
        traceback_cuda.dense_walk_plan(N, M, optin)


def test_dense_walk_plan_takes_what_just_fits():
    plan = traceback_cuda.dense_walk_plan(176, 160, 34384 + 1024)
    assert plan.smem_bytes == 34384
    with pytest.raises(ValueError, match="dense_traceback_walk_cuda"):
        traceback_cuda.dense_walk_plan(176, 160, 34384 + 1023)
