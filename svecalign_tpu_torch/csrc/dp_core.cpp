// Host implementation of the alignment DPs with float64 accumulation: the
// `native` banded-DP backend of the per-pair aligner, and the parity
// oracle of the float32 kernels.
//
// A copy of the JAX package's native/dp_core.cpp, built by the port
// itself (svecalign_tpu_torch/ops/dp_native.py, with the same g++ flags,
// so that both builds agree bit for bit). Same contracts as the plain DPs
// of svecalign_tpu_torch/ops/dp.py; exposed via ctypes.
//
// Implementation notes: the banded DP exploits the same algebraic fact as
// the device kernels — for a fixed output row and alignment type, every
// band cell's predecessor is one uniform shift — so the inner loop is a
// contiguous shifted read the compiler can vectorize.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr int kNegBp = -42;
}  // namespace

extern "C" {

// Full 2-D DP over an (n, m) cost matrix. csum: (n+1, m+1) double,
// bp: (n+1, m+1) int32 with 0=diag, 1=left, 2=up; bp[0][0]=4.
void sva_dense_dp(const float *costs, int64_t n, int64_t m, double pen,
                  double *csum, int32_t *bp) {
  const int64_t cm = m + 1;
  for (int64_t c = 0; c < cm; ++c) {
    csum[c] = c * pen;
    bp[c] = 1;
  }
  for (int64_t r = 0; r < n + 1; ++r) {
    csum[r * cm] = r * pen;
    bp[r * cm] = 2;
  }
  csum[0] = 0.0;
  bp[0] = 4;

  for (int64_t r = 1; r < n + 1; ++r) {
    const double *prev = csum + (r - 1) * cm;
    double *cur = csum + r * cm;
    int32_t *bpr = bp + r * cm;
    const float *cr = costs + (r - 1) * m;
    for (int64_t c = 1; c < cm; ++c) {
      double best = prev[c - 1] + cr[c - 1];
      int32_t move = 0;
      const double left = cur[c - 1] + pen;
      if (left < best) {
        best = left;
        move = 1;
      }
      const double up = prev[c] + pen;
      if (up < best) {
        best = up;
        move = 2;
      }
      cur[c] = best;
      bpr[c] = move;
    }
  }
}

// Banded DP along a search path. costs: (n_types, A, B) float32;
// b_offset_in: (A,); outputs csum: (A+2, B) double, xp/yp: (A+2, B) int32,
// b_offset_out: (A+2,). Alignment types exclude ins/del; (0,1), (1,0) are
// appended internally, preserving first-minimum tie-breaking.
void sva_banded_dp(const float *costs, const int32_t *b_offset_in,
                   int64_t n_types_in, int64_t A, int64_t B,
                   const int32_t *xo_in, const int32_t *yo_in,
                   double del_penalty, int64_t x_in, int64_t y_in,
                   double *csum, int32_t *xp, int32_t *yp,
                   int32_t *b_offset_out) {
  const int64_t a2 = A + 2;
  const int64_t n_types = n_types_in + 2;
  std::vector<int32_t> xo(n_types), yo(n_types);
  for (int64_t t = 0; t < n_types_in; ++t) {
    xo[t] = xo_in[t];
    yo[t] = yo_in[t];
  }
  xo[n_types_in] = 0;
  yo[n_types_in] = 1;  // insertion
  xo[n_types_in + 1] = 1;
  yo[n_types_in + 1] = 0;  // deletion

  b_offset_out[0] = b_offset_in[0];
  b_offset_out[1] = b_offset_in[0];
  for (int64_t a = 0; a < A; ++a) b_offset_out[a + 2] = b_offset_in[a] + 1;

  const int64_t x_out = x_in + 1;
  const int64_t y_out = y_in + 1;

  for (int64_t aa = 0; aa < a2; ++aa) {
    const int32_t boff_a = b_offset_out[aa];
    double *row = csum + aa * B;
    int32_t *xpr = xp + aa * B;
    int32_t *ypr = yp + aa * B;

    // initialize to unreachable
    for (int64_t b = 0; b < B; ++b) {
      row[b] = kInf;
      xpr[b] = kNegBp;
      ypr[b] = kNegBp;
    }

    for (int64_t t = 0; t < n_types; ++t) {
      const int32_t xot = xo[t], yot = yo[t];
      const int64_t s = xot + yot;
      if (aa < s) continue;
      const int64_t prev_a = aa - s;
      const int32_t shift = boff_a - yot - b_offset_out[prev_a];
      const double *prev = csum + prev_a * B;
      const bool is_indel = (xot == 0 || yot == 0);
      if (!is_indel && (aa < 2 || aa - 2 >= A)) continue;  // off the cost grid
      const float *cost_row =
          is_indel ? nullptr : costs + t * A * B + (aa - 2) * B;

      for (int64_t b = 0; b < B; ++b) {
        const int64_t yy = boff_a + b;
        const int64_t xx = aa - yy;
        const int64_t xx_in = xx - 1, yy_in = yy - 1;
        const int64_t xx_prev = xx - xot, yy_prev = yy - yot;
        if (xx_in < 0 || xx_in >= x_in || yy_in < 0 || yy_in >= y_in ||
            xx_prev < 0 || xx_prev >= x_out || yy_prev < 0 ||
            yy_prev >= y_out)
          continue;
        const int64_t pb = b + shift;
        if (pb < 0 || pb >= B) continue;
        const double cost = is_indel ? del_penalty : (double)cost_row[b];
        const double total = prev[pb] + cost;
        if (total < row[b]) {
          row[b] = total;
          xpr[b] = xot;
          ypr[b] = yot;
        }
      }
    }

    // edge-case overrides (all-insertion column / all-deletion row)
    for (int64_t b = 0; b < B; ++b) {
      const int64_t yy = boff_a + b;
      const int64_t xx = aa - yy;
      if (xx == 0 && yy >= 0 && yy < y_out) {
        row[b] = del_penalty * yy;
        xpr[b] = 0;
        ypr[b] = 1;
      } else if (yy == 0 && xx >= 0 && xx < x_out) {
        row[b] = del_penalty * xx;
        xpr[b] = 1;
        ypr[b] = 0;
      }
    }
  }
}

}  // extern "C"
