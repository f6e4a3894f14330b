// Shared pieces of the fixed-mesh TF-semantics position attention (#13):
// the keep rule, the tile shape, the kept-step lists, the cp.async ring and
// the register-tiled product that posatt_tf_fixed_fwd.cu and
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
//
// The kept-step lists. A local op (with thresholds) keeps a few per cent of
// each row for a head of scale > 0, so the kernels contract over listed
// steps only. Columns and rows are cut into steps of SW = 16; the plan pass
// (posatt_tf_fixed_fwd.cu) writes, per head:
//   fwd lists (H, nF, nT): for each row tile of the forward's blocks (128,
//     64 or 32 rows), the 16-column steps that hold a kept entry of one of
//     its rows (every step where one of its rows keeps nothing: such a row
//     weighs every column);
//   dv lists (H, nD, nU): for each column tile of dv's blocks, the 16-row
//     steps that hold a kept entry in its columns or a row that keeps
//     nothing;
//   tile flags (H, nI, nJ): whether a 128 x 128 tile keeps an entry (dscale
//     skips the others: unkept entries and empty rows add nothing to ds);
// each list ascending, its count beside it and -1 after its end. A global
// op (no thresholds) has no lists: every step is walked.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tffixed {

constexpr int BM = 128;       // rows (or columns) of a block's output tile
constexpr int BN = 128;       // (sample, value column) pairs of a block's tile
constexpr int SW = 16;        // depth of one step, and the lists' granularity
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int MAX_BT = 8;     // samples in one column tile
constexpr int MAXH = 8;       // heads the plan pass walks per read of a row

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float keep_threshold(const float* thr, int i, float s, int mode) {
  if (thr == nullptr) return INFINITY;
  const float t0 = thr[2 * (size_t)i];
  if (mode == 0) return t0;
  return s >= 0.f ? __fmul_rn(s, t0) : __fmul_rn(s, thr[2 * (size_t)i + 1]);
}

__device__ __forceinline__ bool kept(float d, float sd, float t, int mode) {
  return mode == 0 ? d <= t : sd <= t;
}

// x / l rounded to nearest, from rl = RN(1 / l): the quotient x * rl
// corrected once by its exact residual (Markstein), which is RN(x / l)
// outside the subnormal range, without the division's slow-path call (a
// call inside a product's loop spills its accumulators)
__device__ __forceinline__ float div_rn(float x, float l, float rl) {
  const float q = __fmul_rn(x, rl);
  return fmaf(fmaf(-q, l, x), rl, q);
}

// the weight of one entry, rounded as the plain version's softmax rounds
// it: exp(m - s*d) / l where kept, 0 elsewhere, 1 / Li on a row that keeps
// nothing (m = +inf, l = Li); rl = RN(1 / l)
__device__ __forceinline__ float weight(float d, float s, float t, float m, float l, float rl,
                                        int mode) {
  if (isinf(m)) return rl;
  const float sd = __fmul_rn(s, d);
  return kept(d, sd, t, mode) ? div_rn(expf(__fsub_rn(m, sd)), l, rl) : 0.f;
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

// How the (sample, value column) pairs of one head are cut into column tiles:
// up to 8 samples a tile, so that every block applies its weights to all
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

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 bytes, or zeros where !ok (src is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes (both ends 16-byte aligned), or zeros where !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every group but the newest `n` has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ the product

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// The row (r = 0..7) or column of a thread's 8 x 8 outputs in a 128-wide tile:
// 4 at 4 * t and 4 at 64 + 4 * t, so that each operand is read as two float4s.
__device__ __forceinline__ int lane_pos(int t, int r) { return (r < 4 ? 0 : 60) + 4 * t + r; }

// The rows of a thread's RT x 8 outputs in a tile of 16 * RT rows (RT = 8,
// 4 or 2): as lane_pos for RT = 8, else RT adjacent rows at RT * t.
template <int RT>
__device__ __forceinline__ int row_pos(int t, int r) {
  return RT == 8 ? lane_pos(t, r) : RT * t + r;
}

// v[r] = p[row_pos<RT>(t, r)], and its store: one or two vector accesses
template <int RT>
__device__ __forceinline__ void lds_rows(const float* p, int t, float* v) {
  if (RT == 8) {
    lds4(p + 4 * t, v);
    lds4(p + 64 + 4 * t, v + 4);
  } else if (RT == 4) {
    lds4(p + 4 * t, v);
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p + 2 * t);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int RT>
__device__ __forceinline__ void sts_rows(float* p, int t, const float* v) {
  if (RT == 8) {
    *reinterpret_cast<float4*>(p + 4 * t) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 64 + 4 * t) = make_float4(v[4], v[5], v[6], v[7]);
  } else if (RT == 4) {
    *reinterpret_cast<float4*>(p + 4 * t) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p + 2 * t) = make_float2(v[0], v[1]);
  }
}

// acc += A^T B over one step: A (SW, LDA) and B (SW, LDB) in shared memory,
// indexed by depth first; thread (tx, ty) owns rows row_pos<RT>(ty, .) and
// columns lane_pos(tx, .). Each output sums its terms in the order of k.
template <int RT, int LDA, int LDB>
__device__ __forceinline__ void step_product(const float* A, const float* B, int tx, int ty,
                                             float (&acc)[RT][8]) {
#pragma unroll
  for (int k = 0; k < SW; ++k) {
    float a[RT], b[8];
    lds_rows<RT>(A + k * LDA, ty, a);
    lds4(B + k * LDB + 4 * tx, b);
    lds4(B + k * LDB + 64 + 4 * tx, b + 4);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// One operand of the forward and dv: SW rows (k) of a column tile of
// per-head values (or cotangents) src (B, rows, H*V), head h, at rows
// r0 + k, into dst (SW, BN). With `vec`, four columns a 16-byte copy (CW and
// V multiples of 4, the base aligned), else one a copy. Each thread's
// column is the same at every step: `at` and `ok` come from stage_cols.
struct ColStage {
  const float* base;  // this thread's first column's address at row 0
  int n;              // its first column in the tile
  int k0;             // its first row in the step
  bool ok;            // its column holds a (sample, value column) pair
};

__device__ __forceinline__ ColStage stage_cols(const Cols& cols, const float* src, int B,
                                               int rows, int H, int V, int h, bool vec,
                                               int tid) {
  ColStage cs;
  cs.n = vec ? 4 * (tid % (BN / 4)) : tid % BN;
  cs.k0 = vec ? tid / (BN / 4) : tid / BN;
  int b, c;
  cs.ok = cols.at(cs.n, B, V, &b, &c);
  cs.base = cs.ok ? src + (size_t)b * rows * H * V + (size_t)h * V + c : src;
  return cs;
}

__device__ __forceinline__ void load_cols(float* dst, const ColStage& cs, int r0, int rows,
                                          int HV, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < SW * BN / 4 / THREADS; ++q) {
      const int k = cs.k0 + q * (THREADS / (BN / 4)), r = r0 + k;
      const bool ok = cs.ok && r < rows;
      cp16(dst + k * BN + cs.n, ok ? cs.base + (size_t)r * HV : cs.base, ok);
    }
  } else {
#pragma unroll
    for (int q = 0; q < SW * BN / THREADS; ++q) {
      const int k = cs.k0 + q * (THREADS / BN), r = r0 + k;
      const bool ok = cs.ok && r < rows;
      cp4(dst + k * BN + cs.n, ok ? cs.base + (size_t)r * HV : cs.base, ok);
    }
  }
}

// Write a thread's RT x 8 outputs into dst (B, rows, H*V) of head h at rows
// o0 + row_pos<RT>(ty, .): four columns a float4 with `vec`.
template <int RT>
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[RT][8],
                                           const Cols& cols, int o0, int rows, int B, int H,
                                           int V, int h, int tx, int ty, bool vec) {
  const int HV = H * V;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int n0 = lane_pos(tx, 4 * g);
    int b, c;
    const bool ok0 = cols.at(n0, B, V, &b, &c);
    if (vec) {
      if (!ok0) continue;
      float* o = dst + (size_t)b * rows * HV + (size_t)h * V + c;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = o0 + row_pos<RT>(ty, r);
        if (i < rows)
          *reinterpret_cast<float4*>(o + (size_t)i * HV) =
              make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 4 * g + e;
        int bq, cq;
        if (!cols.at(lane_pos(tx, q), B, V, &bq, &cq)) continue;
        float* o = dst + (size_t)bq * rows * HV + (size_t)h * V + cq;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = o0 + row_pos<RT>(ty, r);
          if (i < rows) o[(size_t)i * HV] = acc[r][q];
        }
      }
    }
  }
}

// The share of a list (ascending, cnt entries; null: every step 0...n-1)
// that split `split` walks: [*beg, *end), the entries in its raw range of
// `chunk` steps. A split sums a fixed range of the reduction, as a split
// of the plain version's product does, wherever the kept entries lie.
// Called by every thread of the block.
__device__ __forceinline__ void split_range(const int* lst, int cnt, int split, int chunk,
                                            int* beg, int* end) {
  const int lo = split * chunk, hi = lo + chunk;
  if (lst == nullptr) {
    *beg = min(lo, cnt);
    *end = min(hi, cnt);
    return;
  }
  __shared__ int below[2];
  if (threadIdx.x < 2) below[threadIdx.x] = 0;
  __syncthreads();
  int a = 0, b = 0;
  for (int p = threadIdx.x; p < cnt; p += blockDim.x) {
    const int v = __ldg(lst + p);
    a += v < lo;
    b += v < hi;
  }
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  if (threadIdx.x % 32 == 0) {
    atomicAdd(&below[0], a);  // integers: exact in any order
    atomicAdd(&below[1], b);
  }
  __syncthreads();
  *beg = below[0];
  *end = below[1];
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
