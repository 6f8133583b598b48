"""The launch plans of the stage-5.4 kernels that hold their work in
shared memory: ``ops/dense_dp_cuda.py::dense_dp_plan`` (warps and shared
memory of ``csrc/dense_dp.cu``) and ``ops/traceback_cuda.py::
banded_walk_plan`` (the successor ring of ``csrc/traceback_walk.cu``).
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
