// Shared pieces of the fixed-mesh TF-semantics position attention (#13):
// the keep rule, the attention weight of one entry, the tile shape and the
// register-tiled product that posatt_tf_fixed_fwd.cu and
// posatt_tf_fixed_bwd.cu both run. float32 throughout.
//
// For head h of scale s (either sign), output row i and input column j of
// the (Lo, Li) distance matrix d that the whole batch shares:
//
//   t[h,i]   = +inf without thresholds; else thr[i,0] for mode 0 (tan_sin,
//              square), and for mode 1 (tan) s*thr[i,0] if s >= 0 else
//              s*thr[i,1] (the quantile at 1 - p: a negative scale reverses
//              the order)
//   keep     = d <= t (mode 0), or s*d <= t (mode 1, the two f32 products)
//   m[h,i]   = min over kept j of s*d (minus the row's largest logit)
//   l[h,i]   = sum over kept j of exp(m - s*d)
//   w[h,i,j] = keep ? exp(m - s*d) / l : 0
//
// as models/pit_tf.py's MultiHeadPosAtt in the JAX package computes it: its
// float-max sentinel gives masked entries exactly 0, and a row that keeps
// nothing a uniform 1 / Li, which m = +inf marks here (l is then Li).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tffixed {

constexpr int BM = 128;       // rows of a block's tile
constexpr int BN = 128;       // columns of a block's tile
constexpr int BK = 8;         // depth of one step
constexpr int PAD = 4;        // padding of a tile stored transposed
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int MAX_BT = 8;     // samples in one column tile

__device__ __forceinline__ float keep_threshold(const float* thr, int i, float s, int mode) {
  if (thr == nullptr) return INFINITY;
  const float t0 = thr[2 * (size_t)i];
  if (mode == 0) return t0;
  return s >= 0.f ? __fmul_rn(s, t0) : __fmul_rn(s, thr[2 * (size_t)i + 1]);
}

__device__ __forceinline__ bool kept(float d, float sd, float t, int mode) {
  return mode == 0 ? d <= t : sd <= t;
}

// the weight of one entry, and in *k whether it is kept
__device__ __forceinline__ float weight(float d, float s, float t, float m, float l, int mode,
                                        bool* k) {
  const float sd = __fmul_rn(s, d);
  *k = kept(d, sd, t, mode);
  if (isinf(m)) return __fdiv_rn(1.f, l);  // the row keeps nothing: uniform
  return *k ? __fdiv_rn(expf(__fsub_rn(m, sd)), l) : 0.f;
}

// A column tile of the per-head values: BT samples of CW value columns each,
// column n of the tile is sample b0 + n / CW, value column c0 + n % CW.
struct Cols {
  int b0, c0, BT, CW;
  __device__ __forceinline__ bool at(int n, int B, int V, int* b, int* c) const {
    const int bl = n / CW;
    *b = b0 + bl;
    *c = c0 + n % CW;
    return bl < BT && *b < B && *c < V;
  }
};

__device__ __forceinline__ Cols cols_of(int tile, int BT, int CW, int nct) {
  return Cols{(tile / nct) * BT, (tile % nct) * CW, BT, CW};
}

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// The row (r = 0..7) or column of a thread's 8 x 8 outputs in a 128-wide tile:
// 4 at 4 * t and 4 at 64 + 4 * t, so that each operand is read as two float4s.
__device__ __forceinline__ int lane_pos(int t, int r) { return (r < 4 ? 0 : 60) + 4 * t + r; }

// acc += A^T B over one step: A (BK, lda) and B (BK, ldb) in shared memory,
// indexed by depth first; thread (tx, ty) owns rows lane_pos(ty, .) and
// columns lane_pos(tx, .).
template <int LDA, int LDB>
__device__ __forceinline__ void step_product(float (*A)[LDA], float (*B)[LDB],
                                             int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[8], b[8];
    lds4(&A[k][4 * ty], a);
    lds4(&A[k][64 + 4 * ty], a + 4);
    lds4(&B[k][4 * tx], b);
    lds4(&B[k][64 + 4 * tx], b + 4);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// Where a launch has too few blocks to fill the card (few output rows, a
// long reduction: the encoders' 256 or 1,024 latent rows against thousands
// of grid points), the wrapper splits the reduction axis into `splits`
// ranges of `kchunk` (a multiple of BK) each; block z = split * H + h writes
// its partial sums to part (splits, B, rows, H*V), and sum_splits adds them
// in order into the output.
//
// How the (sample, value column) pairs of one head are cut into column tiles:
// up to 8 samples a tile, so that every block applies its distances to all
// the samples of a batch of 8 or fewer, and 128 / BT value columns of each.
struct ColPlan {
  int BT, CW, nct, tiles;
};

inline ColPlan col_plan(int B, int V) {
  ColPlan p;
  p.BT = B < MAX_BT ? B : MAX_BT;
  int cw = BN / p.BT;
  if (cw > V) cw = V;
  p.nct = (V + cw - 1) / cw;
  p.CW = (V + p.nct - 1) / p.nct;  // balanced: no tile much narrower than the rest
  p.tiles = ((B + p.BT - 1) / p.BT) * p.nct;
  return p;
}

// out[i] = sum over s of part[s * n + i], s in order: the same bits on every run
__global__ void __launch_bounds__(THREADS) sum_splits_kernel(const float* __restrict__ part,
                                                             float* __restrict__ out, size_t n,
                                                             int splits) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
    out[i] = v;
  }
}

inline cudaError_t sum_splits(const float* part, float* out, size_t n, int splits,
                              cudaStream_t st) {
  size_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(part, out, n, splits);
  return cudaGetLastError();
}

}  // namespace tffixed
