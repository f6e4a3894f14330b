// TF-semantics position attention, forward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Two C entry points, one per TPU kernel:
//
//   posatt_tf_fwd        replaces _make_tf_fwd_kernel, launched by
//                        _posatt_tf_raw (pallas_call at
//                        position_induced_transformer_tpu/kernels/
//                        posatt_batched.py:733): pre-built distances
//                        dist (B, Lo, Li);
//   posatt_tf_coord_fwd  replaces _make_tf_coord_fwd_kernel, launched by
//                        _posatt_tf_coord_raw (pallas_call at :1175):
//                        distances from coordinates mq (B, Lo, dd) and mk
//                        (B, Li, dd) on the extended key axis, with an
//                        optional band (starts, width, tile_rows).
//
// For sample b, output row i, head h and value column k of head h, over the
// row's column window W (the whole key axis, or the band [start, start +
// width) clipped to it, start = starts[b, i / tile_rows]):
//
//   d[i,j]   = dist[b,i,j], or sum_c (q[i,c] - k[j,c])^2 (diff, square, sum
//              in c order; the caller folds the TF halving into the scale
//              and the thresholds)
//   keep     = j in W and d <= thr[b,i] (every column of W without thr)
//   dmin[i]  = min over W of d (the bare minimum)
//   p[h,i,j] = keep ? exp(-(d - dmin) * scale[h]) : 0
//   out[b, i, h*V + k] = sum_j p values[b, j, h*V + k] / max(sum_j p, 1e-30)
//
// Values are per head: head h reads only its own V columns. With a non-null
// `stats` the kernel also writes, per row, dmin, the keep threshold (+inf
// without thr) and per head the reciprocal denominator, (B, H + 2, Lo): the
// residuals of the backward kernels in posatt_tf_bwd.cu.
//
// What bounds it on this card: 2*V operations per kept entry and head (2*H*V
// in all), plus 3*dd per distance inspected when it recomputes them, against
// inputs of the coordinates (or the (B, Lo, Li) distances), the values and
// the (B, Lo, H*V) output. At the elasticity_tf processor (every entry of a
// 972 x 972 window kept, H*V = 512) that is far above the f32 ridge of 20
// operations per byte, so the f32 CUDA-core rate bounds it; the banded
// encoder and decoder keep about 20 columns a row and bytes bound them.
// With pre-built distances the 37.8 MB a batch of them takes at L = 972
// bounds a thresholded op.
//
// What the design does about it:
// - A block owns one head, a tile of that head's value columns (32, 64 or
//   128, the least that covers V) and 16 rows of one sample, so each weight
//   is computed once per column tile and feeds V products; the distances,
//   which cost less than the exp, are recomputed per head (or re-read, where
//   the L2 cache holds the rows the heads' blocks share).
// - Two passes: a warp per row finds dmin over the window; the column loop
//   then computes each weight once, stages it and the values in shared
//   memory, contracts with a register-tiled f32 product (4 rows x CPL
//   columns per thread), and sums the denominators beside it: the
//   normalisation is deferred to the output, as the TPU kernel #11 does.
//   Sums in fixed orders: the same bits on every run.
// - Distances from coordinates are written with __fsub_rn / __fmul_rn /
//   __fadd_rn, so that no FMA contraction moves a kept set: they are bit for
//   bit ops/distances.euclidean_sq's.
// - A step whose weights are all zero skips its value loads and products;
//   a block stays inside one band tile (16 divides the tile height), so its
//   window is block-uniform. Rows, window columns past the key axis and
//   value columns past V are masked by index (the TPU kernels pad instead).
// Tensor cores are not used: TF32 would not hold parity with the f32 oracle.
//
// Each function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;  // coordinates per point
constexpr int TLO = 16;     // rows per block: divides every band tile height
constexpr int NWARPS = 4;
constexpr int RPT = 4;      // rows per thread in the product
constexpr int TLI = 32;     // window columns per step
constexpr int THREADS = NWARPS * 32;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// squared distance in the op order of ops/distances.euclidean_sq, without
// contraction into FMAs
__device__ __forceinline__ float sqdist(const float (&q)[MAX_DIM], const float* k, int dd) {
  float df = __fsub_rn(q[0], k[0]);
  float d = __fmul_rn(df, df);
#pragma unroll
  for (int c = 1; c < MAX_DIM; ++c) {
    if (c < dd) {
      df = __fsub_rn(q[c], k[c]);
      d = __fadd_rn(d, __fmul_rn(df, df));
    }
  }
  return d;
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = p[i];
}
template <>
__device__ __forceinline__ void lds<4>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// The inputs of one launch. COORDS: distances from mq/mk (and the band);
// otherwise read from dist.
struct Args {
  const float* dist;    // (B, Lo, Li) or null
  const float* mq;      // (B, Lo, dd) or null
  const float* mk;      // (B, Li, dd) or null
  const float* scale;   // (H)
  const float* values;  // (B, Li, H*V)
  const float* thr;     // (B, Lo) or null
  const int* starts;    // (B, n_tiles) or null
  float* out;           // (B, Lo, H*V)
  float* stats;         // (B, H+2, Lo) or null
  int Lo, Li, H, V, dd, width, tile_rows, n_tiles;
};

// Warp w owns rows [w*RPT, w*RPT + RPT) of the product, lane c the value
// columns [c*CPL, c*CPL + CPL) of the block's tile.
template <bool COORDS, int CPL>
__global__ void __launch_bounds__(THREADS) tf_fwd_kernel(const Args a) {
  constexpr int TN = 32 * CPL;
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_p[TLI][TLO];  // unnormalised weights
  __shared__ __align__(16) float s_v[TLI][TN];   // the head's values
  __shared__ float s_q[TLO][MAX_DIM];
  __shared__ float s_dmin[TLO];
  __shared__ float s_thr[TLO];
  __shared__ float s_den[THREADS];  // each thread's share of its row's denominator

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ct = (a.V + TN - 1) / TN;
  const int h = blockIdx.x / n_ct;
  const int ct = blockIdx.x - h * n_ct;
  const int col0 = ct * TN;  // within the head's V columns
  const int row0 = blockIdx.y * TLO;
  const int b = blockIdx.z;
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V;
  const float s = a.scale[h];
  const float* distb = COORDS ? nullptr : a.dist + (size_t)b * Lo * Li;
  const float* mkb = COORDS ? a.mk + (size_t)b * Li * a.dd : nullptr;
  const float* vb = a.values + (size_t)b * Li * HV + (size_t)h * a.V;

  // the block's column window, the same for all its rows
  int j_begin = 0, j_end = Li;
  if (COORDS && a.starts != nullptr) {
    const int st = a.starts[(size_t)b * a.n_tiles + row0 / a.tile_rows];
    j_begin = max(st, 0);
    j_end = min(st + a.width, Li);
  }
  if (COORDS) {
    for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
      const int r = e / MAX_DIM, c = e - r * MAX_DIM;
      const int i = row0 + r;
      s_q[r][c] = (i < Lo && c < a.dd) ? a.mq[((size_t)b * Lo + i) * a.dd + c] : 0.f;
    }
    __syncthreads();
  }

  // distance of block row r (global row i) to key j
  auto dist_at = [&](int r, int i, int j) -> float {
    if constexpr (COORDS) {
      float q[MAX_DIM];
#pragma unroll
      for (int c = 0; c < MAX_DIM; ++c) q[c] = s_q[r][c];
      return sqdist(q, mkb + (size_t)j * a.dd, a.dd);
    } else {
      return distb[(size_t)i * Li + j];
    }
  };

  // ---- pass 1: the bare window minimum and the threshold, a warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    const int i = row0 + r;
    if (i >= Lo) {  // never written; keeps nothing
      if (lane == 0) { s_dmin[r] = 0.f; s_thr[r] = -INFINITY; }
      continue;
    }
    float mn = INFINITY;
    for (int j = j_begin + lane; j < j_end; j += 32) mn = fminf(mn, dist_at(r, i, j));
    mn = warp_min(mn);
    if (lane == 0) {
      s_dmin[r] = mn;
      s_thr[r] = a.thr != nullptr ? a.thr[(size_t)b * Lo + i] : INFINITY;
    }
  }
  __syncthreads();

  // ---- pass 2: weights once each, staged with the values, contracted
  const int rp = tid % TLO;  // the row this thread computes weights for
  const int ip = row0 + rp;
  const float tp = s_thr[rp];
  const float dminp = s_dmin[rp];
  const int cv = tid % TN;  // the value column this thread stages
  const bool col_ok = col0 + cv < a.V;
  float den = 0.f;

  float acc[RPT][CPL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += TLI) {
    int any = 0;
#pragma unroll
    for (int q = 0; q < TLI * TLO / THREADS; ++q) {
      const int jj = tid / TLO + q * (THREADS / TLO);
      const int j = j0 + jj;
      const bool ok = ip < Lo && j < j_end;
      const float d = ok ? dist_at(rp, ip, j) : 0.f;
      const bool k = ok && d <= tp;
      any |= k;
      const float p = k ? expf(-__fsub_rn(d, dminp) * s) : 0.f;
      den += p;
      s_p[jj][rp] = p;
    }
    if (__syncthreads_or(any)) {  // block-uniform: the values only when needed
#pragma unroll
      for (int q = 0; q < TLI * TN / THREADS; ++q) {
        const int jj = tid / TN + q * (THREADS / TN);
        const int j = j0 + jj;
        s_v[jj][cv] = (col_ok && j < j_end) ? vb[(size_t)j * HV + col0 + cv] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TLI; ++jj) {
        float vv[CPL], pv[RPT];
        lds<CPL>(&s_v[jj][lane * CPL], vv);
        lds<RPT>(&s_p[jj][warp * RPT], pv);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

  // ---- the denominators: row r's shares sit at tid = r + TLO * k
  s_den[tid] = den;
  __syncthreads();
  const bool write_stats = a.stats != nullptr && ct == 0;
  if (write_stats && tid < TLO && row0 + tid < Lo) {
    float sum = 0.f;
    for (int k = 0; k < THREADS / TLO; ++k) sum += s_den[tid + TLO * k];
    const int i = row0 + tid;
    float* st = a.stats + (size_t)b * (a.H + 2) * Lo + i;
    st[(size_t)(2 + h) * Lo] = 1.f / fmaxf(sum, 1e-30f);
    if (h == 0) { st[0] = s_dmin[tid]; st[Lo] = s_thr[tid]; }
  }

  // ---- normalise and write the head's columns
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int rr = warp * RPT + r;
    const int i = row0 + rr;
    if (i >= Lo) continue;
    float sum = 0.f;
    for (int k = 0; k < THREADS / TLO; ++k) sum += s_den[rr + TLO * k];
    const float rden = 1.f / fmaxf(sum, 1e-30f);
    float* dst = a.out + ((size_t)b * Lo + i) * HV + (size_t)h * a.V + col0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = lane * CPL + c;
      if (col0 + n < a.V) dst[n] = acc[r][c] * rden;
    }
  }
}

template <bool COORDS, int CPL>
void launch_tiles(const Args& a, int B, cudaStream_t stream) {
  constexpr int TN = 32 * CPL;
  const dim3 grid(a.H * ((a.V + TN - 1) / TN), (a.Lo + TLO - 1) / TLO, B);
  tf_fwd_kernel<COORDS, CPL><<<grid, THREADS, 0, stream>>>(a);
}

// the value columns a block owns: 32, 64 or 128, the least that covers V
// (V = 64 at elasticity_tf: 512 hidden over 8 heads)
template <bool COORDS>
int launch(const Args& a, int B, cudaStream_t s) {
  if (a.V <= 32)
    launch_tiles<COORDS, 1>(a, B, s);
  else if (a.V <= 64)
    launch_tiles<COORDS, 2>(a, B, s);
  else
    launch_tiles<COORDS, 4>(a, B, s);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Lo, int Li, int H, int V) {
  return B < 1 || Lo < 1 || Li < 1 || H < 1 || V < 1 || B > 65535 || (Lo + TLO - 1) / TLO > 65535;
}

}  // namespace

extern "C" int posatt_tf_fwd(const float* dist, const float* thr, const float* scale,
                             const float* values, float* out, float* stats, int B, int Lo,
                             int Li, int H, int V, void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  const Args a{dist, nullptr, nullptr, scale, values, thr, nullptr, out, stats,
               Lo, Li, H, V, 0, 0, Lo, 1};
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_fwd(const float* mq, const float* mk, const float* scale,
                                   const float* values, const float* thr, const int* starts,
                                   float* out, float* stats, int B, int Lo, int Li, int H,
                                   int V, int dd, int width, int tile_rows, void* stream) {
  // a block of TLO rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TLO == 0);
  if (bad_shape(B, Lo, Li, H, V) || dd < 1 || dd > MAX_DIM || !tiles_ok ||
      (starts != nullptr && width < 1))
    return (int)cudaErrorInvalidValue;
  const Args a{nullptr, mq, mk, scale, values, thr, starts, out, stats,
               Lo, Li, H, V, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows};
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}
