"""The least time of each launch of the four DP and walk kernels, from the
shapes of its pairs: each input byte that the pairs need read once, each
output byte written once, against the operations of the recurrence at the
float32 peak outside the tensor cores; the larger of the two. Per pair of
``x`` by ``y`` segments at a level:

- dense DP: costs read (x y fp32), the move plane written ((x+1)(y+1)
  int8); 5 operations a node (three adds, two compares);
- banded DP: costs read (T types over the path's x + y + 1 anti-diagonals
  and B lanes, fp32), cumulative costs and two pointer planes written
  (x + y + 3 rows of B lanes: fp32 and two int8); 2 operations a
  candidate (an add and a compare), T + 2 candidates a node;
- dense walk: the path's x + y + 1 moves read (int8), its steps written
  (two int32 and one int8 each, the padded steps of the launch);
- banded walk: the path's nodes read (fp32 and two int8 each), its steps
  written (two int32, two int8 and one fp32 each, the padded steps).
"""

from bench_port.counts.peaks import FP32_FLOPS, HBM_BYTES_PER_S


def launch_bound_s(kind: str, shape: dict) -> float:
    xs, ys = shape["x"], shape["y"]
    nbytes = ops = 0.0
    for x, y in zip(xs, ys):
        if kind == "dense_dp_cuda":
            nbytes += 4.0 * x * y + (x + 1) * (y + 1)
            ops += 5.0 * x * y
        elif kind == "banded_dp_cuda_batched":
            a, T, B = x + y + 1, shape["T"], shape["B"]
            nbytes += 4.0 * T * a * B + 6.0 * (a + 2) * B
            ops += 2.0 * (T + 2) * (a + 2) * B
        elif kind == "dense_traceback_walk_cuda":
            nbytes += (x + y + 1) + 9.0 * shape["steps"]
        else:
            nbytes += 6.0 * (x + y + 1) + 14.0 * shape["a2"]
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


KERNEL_NAMES = {"dense_dp_cuda": "dense_dp", "banded_dp_cuda_batched": "banded_dp",
                "dense_traceback_walk_cuda": "dense_walk",
                "banded_traceback_walk_cuda": "banded_walk"}
