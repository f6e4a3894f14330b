// TF-semantics position attention, backward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Four C entry points, two per TPU kernel:
//
//   posatt_tf_bwd_dscale, posatt_tf_bwd_dv
//       replace _make_tf_bwd_kernel, launched by _posatt_tf_bwd_raw
//       (pallas_call at position_induced_transformer_tpu/kernels/
//       posatt_batched.py:779): pre-built distances dist (B, Lo, Li);
//   posatt_tf_coord_bwd_dscale, posatt_tf_coord_bwd_dv
//       replace _make_tf_coord_bwd_kernel, launched by
//       _posatt_tf_coord_bwd_raw (pallas_call at :1236): distances from
//       coordinates mq (B, Lo, dd) and mk (B, Li, dd) on the extended key
//       axis, with an optional band (starts, width, tile_rows).
//
// dscale -> d(loss)/d(scale) per sample and head, (B, H); dv ->
// d(loss)/d(values), (B, Li, H*V), on the extended key axis for the
// coordinate kernel (the caller's concat routes the wrap margin's share
// back). Notation as in posatt_tf_fwd.cu, plus the output's cotangent g
// (B, Lo, H*V) and the forward's row statistics stats (B, H+2, Lo): dmin,
// the keep threshold t and the reciprocal denominators rden_h. On a kept
// entry (j in the row's window, d <= t)
//
//   P_h[i,j] = exp(-(d[i,j] - dmin[i]) * scale[h]) * rden_h[i]
//
// and P is exactly 0 elsewhere. Distances are recomputed in the forward's
// op order without FMA contraction, so the kept sets are the forward's.
//
// The TPU kernels walk a sample's row tiles in order and carry dValues and
// dScale across grid steps; blocks on the card run in parallel and carry
// nothing, so the work is split as posatt_batched_bwd.cu splits it:
//
// dscale: the TPU kernel sums, per row, r = sum_j P T, v = sum_j P (-d) and
// w = sum_j P T (-d) with T = G_h V_h^T, and returns sum_i (w_i - r_i v_i),
//
//   ds[b,h] = sum_{i,k} G_h[i,k] * (Q_h V_h)[i,k],   Q_h = P_h (-d - v_h),
//
// so the product with V_h is the forward's contraction with weights Q. A
// block owns one head, a tile of its value columns and 16 rows: a prologue
// finds v per row (a warp per row), the column loop stages Q and V_h and
// contracts, the epilogue multiplies by G_h and reduces to one partial per
// block. A second kernel sums each (sample, head)'s partials in a fixed
// order: the same bits on every run, no float atomics.
//
// dv: dV_h = P_h^T G_h. A block owns 16 key rows j of one sample, one head
// and a tile of its value columns; it walks only the band tiles whose
// window meets its key rows (every row without a band), stages P_h
// recomputed from the statistics and the matching rows of G_h per step of
// 32 rows, and skips a step without a kept entry before loading G_h. Each
// dv element is written by one block: no atomics.
//
// What bounds them on this card: each does 2*V operations per kept entry
// and head (2*H*V in all) plus the distance's 3*dd, and moves the
// coordinates (or distances), values, statistics and cotangent once. At the
// elasticity_tf processor (every entry of a 972 x 972 window kept, H*V =
// 512) the f32 CUDA-core rate bounds both; at the banded encoder and decoder
// bytes do, and the kernels inspect every column of the band. Tensor cores
// are not used (TF32 would not hold parity with the f32 oracle), there is no
// fast math, and ragged edges are masked by index.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;
constexpr int TLO = 16;  // rows per dscale block, key rows per dv block
constexpr int NWARPS = 4;
constexpr int RPT = 4;
constexpr int TLI = 32;  // window columns (dscale) or rows (dv) per step
constexpr int THREADS = NWARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
  const float* values;  // (B, Li, H*V); dscale only
  const float* g;       // (B, Lo, H*V)
  const float* stats;   // (B, H+2, Lo)
  const int* starts;    // (B, n_tiles) or null
  float* partial;       // (B, H, nparts); dscale only
  float* out;           // ds (B, H) or dv (B, Li, H*V)
  int Lo, Li, H, V, dd, width, tile_rows, n_tiles;
};

// the window [*j_begin, *j_end) of band tile t of sample b; the whole key
// axis without a band
__device__ __forceinline__ void window(const Args& a, int b, int t, int* j_begin, int* j_end) {
  if (a.starts == nullptr) { *j_begin = 0; *j_end = a.Li; return; }
  const int s = a.starts[(size_t)b * a.n_tiles + t];
  *j_begin = max(s, 0);
  *j_end = min(s + a.width, a.Li);
}

// --------------------------------------------------------------- dscale

template <bool COORDS, int CPL>
__global__ void __launch_bounds__(THREADS) dscale_kernel(const Args a) {
  constexpr int TN = 32 * CPL;
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_w[TLI][TLO];  // Q = P (-d - v)
  __shared__ __align__(16) float s_v[TLI][TN];   // the head's values
  __shared__ float s_q[TLO][MAX_DIM];
  __shared__ float s_dmin[TLO];
  __shared__ float s_thr[TLO];
  __shared__ float s_rden[TLO];
  __shared__ float s_nv[TLO];  // sum_j P (-d)
  __shared__ float s_red[NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ct = (a.V + TN - 1) / TN;
  const int h = blockIdx.x / n_ct;
  const int ct = blockIdx.x - h * n_ct;
  const int col0 = ct * TN;
  const int row0 = blockIdx.y * TLO;
  const int b = blockIdx.z;
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V;
  const float s = a.scale[h];
  const float* distb = COORDS ? nullptr : a.dist + (size_t)b * Lo * Li;
  const float* mkb = COORDS ? a.mk + (size_t)b * Li * a.dd : nullptr;
  const float* vb = a.values + (size_t)b * Li * HV + (size_t)h * a.V;
  const float* stb = a.stats + (size_t)b * (a.H + 2) * Lo;
  int j_begin, j_end;
  window(a, b, row0 / a.tile_rows, &j_begin, &j_end);

  for (int r = tid; r < TLO; r += THREADS) {
    const int i = row0 + r;
    s_dmin[r] = i < Lo ? stb[i] : 0.f;
    s_thr[r] = i < Lo ? stb[Lo + i] : -INFINITY;  // a padded row keeps nothing
    s_rden[r] = i < Lo ? stb[(size_t)(2 + h) * Lo + i] : 0.f;
  }
  if (COORDS) {
    for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
      const int r = e / MAX_DIM, c = e - r * MAX_DIM;
      const int i = row0 + r;
      s_q[r][c] = (i < Lo && c < a.dd) ? a.mq[((size_t)b * Lo + i) * a.dd + c] : 0.f;
    }
  }
  __syncthreads();

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

  // ---- prologue: v[i] = sum_j P[i,j] * (-d_ij), a warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    const int i = row0 + r;
    const float t = s_thr[r], mn = s_dmin[r], rd = s_rden[r];
    float v = 0.f;
    if (i < Lo) {
      for (int j = j_begin + lane; j < j_end; j += 32) {
        const float d = dist_at(r, i, j);
        if (d <= t) v += expf(-__fsub_rn(d, mn) * s) * rd * -d;
      }
    }
    v = warp_sum(v);
    if (lane == 0) s_nv[r] = v;
  }
  __syncthreads();

  // ---- Y = Q V_h over column steps, skipping steps without a kept entry
  const int rp = tid % TLO;
  const int ip = row0 + rp;
  const float tp = s_thr[rp], dminp = s_dmin[rp], rdp = s_rden[rp], nvp = s_nv[rp];
  const int cv = tid % TN;
  const bool col_ok = col0 + cv < a.V;

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
      s_w[jj][rp] = k ? expf(-__fsub_rn(d, dminp) * s) * rdp * (-d - nvp) : 0.f;
    }
    if (__syncthreads_or(any)) {
#pragma unroll
      for (int q = 0; q < TLI * TN / THREADS; ++q) {
        const int jj = tid / TN + q * (THREADS / TN);
        const int j = j0 + jj;
        s_v[jj][cv] = (col_ok && j < j_end) ? vb[(size_t)j * HV + col0 + cv] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TLI; ++jj) {
        float vv[CPL], wv[RPT];
        lds<CPL>(&s_v[jj][lane * CPL], vv);
        lds<RPT>(&s_w[jj][warp * RPT], wv);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: sum over the block's (i, k) of G_h * Y
  float part = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + warp * RPT + r;
    if (i >= Lo) continue;
    const float* gp = a.g + ((size_t)b * Lo + i) * HV + (size_t)h * a.V + col0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = lane * CPL + c;
      if (col0 + n < a.V) part = fmaf(acc[r][c], gp[n], part);
    }
  }
  part = warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += s_red[w];
    const size_t nparts = (size_t)gridDim.y * n_ct;
    a.partial[((size_t)b * a.H + h) * nparts + (size_t)blockIdx.y * n_ct + ct] = sum;
  }
}

// one warp per (sample, head); each lane sums a fixed strided set of
// partials, then a fixed butterfly: the same bits on every run
__global__ void __launch_bounds__(32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ ds, int nparts) {
  const int lane = threadIdx.x;
  const size_t bh = blockIdx.x;
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += partial[bh * nparts + p];
  s = warp_sum(s);
  if (lane == 0) ds[bh] = s;
}

// ------------------------------------------------------------------- dv

template <bool COORDS, int CPL>
__global__ void __launch_bounds__(THREADS) dv_kernel(const Args a) {
  constexpr int TN = 32 * CPL;
  static_assert(THREADS % TN == 0 && (TLI * TN) % THREADS == 0, "tile shape");
  __shared__ __align__(16) float s_p[TLI][TLO];  // rows i by the block's key rows
  __shared__ __align__(16) float s_g[TLI][TN];
  __shared__ float s_k[TLO][MAX_DIM];  // the block's key coordinates

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ct = (a.V + TN - 1) / TN;
  const int h = blockIdx.x / n_ct;
  const int ct = blockIdx.x - h * n_ct;
  const int col0 = ct * TN;
  const int j0 = blockIdx.y * TLO;
  const int b = blockIdx.z;
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V;
  const float s = a.scale[h];
  const float* distb = COORDS ? nullptr : a.dist + (size_t)b * Lo * Li;
  const float* mqb = COORDS ? a.mq + (size_t)b * Lo * a.dd : nullptr;
  const float* stb = a.stats + (size_t)b * (a.H + 2) * Lo;
  const float* rden = stb + (size_t)(2 + h) * Lo;

  if (COORDS) {
    for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
      const int r = e / MAX_DIM, c = e - r * MAX_DIM;
      const int j = j0 + r;
      s_k[r][c] = (j < Li && c < a.dd) ? a.mk[((size_t)b * Li + j) * a.dd + c] : 0.f;
    }
    __syncthreads();
  }

  const int cg = tid % TN;  // the column of G_h this thread stages
  const bool col_ok = col0 + cg < a.V;
  const float* gp = a.g + (size_t)b * Lo * HV + (size_t)h * a.V + col0 + (col_ok ? cg : 0);

  float acc[RPT][CPL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  const int n_t = a.starts != nullptr ? a.n_tiles : 1;
  for (int t = 0; t < n_t; ++t) {
    int w_begin, w_end;
    window(a, b, t, &w_begin, &w_end);
    // the columns of this tile's window that are the block's key rows
    const int jb = max(w_begin, j0), je = min(w_end, min(j0 + TLO, Li));
    if (jb >= je) continue;  // block-uniform
    const int i_begin = a.starts != nullptr ? t * a.tile_rows : 0;
    const int i_end = a.starts != nullptr ? min((t + 1) * a.tile_rows, Lo) : Lo;
    for (int i0 = i_begin; i0 < i_end; i0 += TLI) {
      int any = 0;
      for (int e = tid; e < TLI * TLO; e += THREADS) {
        const int ii = e / TLO, jj = e - ii * TLO;
        const int i = i0 + ii, j = j0 + jj;
        const bool ok = i < i_end && j >= jb && j < je;
        float d = 0.f;
        if (ok) {
          if constexpr (COORDS) {
            float q[MAX_DIM];
#pragma unroll
            for (int c = 0; c < MAX_DIM; ++c) q[c] = c < a.dd ? mqb[(size_t)i * a.dd + c] : 0.f;
            d = sqdist(q, s_k[jj], a.dd);
          } else {
            d = distb[(size_t)i * Li + j];
          }
        }
        const bool k = ok && d <= stb[Lo + i];
        any |= k;
        s_p[ii][jj] = k ? expf(-__fsub_rn(d, stb[i]) * s) * rden[i] : 0.f;
      }
      if (__syncthreads_or(any)) {  // block-uniform: G_h only when needed
#pragma unroll
        for (int q = 0; q < TLI * TN / THREADS; ++q) {
          const int ii = tid / TN + q * (THREADS / TN);
          const int i = i0 + ii;
          s_g[ii][cg] = (col_ok && i < i_end) ? gp[(size_t)i * HV] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int ii = 0; ii < TLI; ++ii) {
          float gv[CPL], pv[RPT];
          lds<CPL>(&s_g[ii][lane * CPL], gv);
          lds<RPT>(&s_p[ii][warp * RPT], pv);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(pv[r], gv[c], acc[r][c]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = j0 + warp * RPT + r;
    if (j >= Li) continue;
    float* dst = a.out + ((size_t)b * Li + j) * HV + (size_t)h * a.V + col0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = lane * CPL + c;
      if (col0 + n < a.V) dst[n] = acc[r][c];
    }
  }
}

// --------------------------------------------------------------- launch

// the value columns a block owns: 32, 64 or 128, the least that covers V;
// the partial buffer must hold B * H * ceil(Lo/16) * ceil(V/32) floats
template <bool COORDS, int CPL>
int dscale_tiles(const Args& a, int B, cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const dim3 grid(a.H * ((a.V + TN - 1) / TN), (a.Lo + TLO - 1) / TLO, B);
  dscale_kernel<COORDS, CPL><<<grid, THREADS, 0, s>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<B * a.H, 32, 0, s>>>(a.partial, a.out, (int)(grid.x / a.H * grid.y));
  return (int)cudaGetLastError();
}

template <bool COORDS, int CPL>
int dv_tiles(const Args& a, int B, cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const dim3 grid(a.H * ((a.V + TN - 1) / TN), (a.Li + TLO - 1) / TLO, B);
  dv_kernel<COORDS, CPL><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool COORDS>
int launch_dscale(const Args& a, int B, cudaStream_t s) {
  if (a.V <= 32) return dscale_tiles<COORDS, 1>(a, B, s);
  if (a.V <= 64) return dscale_tiles<COORDS, 2>(a, B, s);
  return dscale_tiles<COORDS, 4>(a, B, s);
}

// G_h is staged per head, so a staged value feeds as many products as in
// the forward: the same column tiles
template <bool COORDS>
int launch_dv(const Args& a, int B, cudaStream_t s) {
  if (a.V <= 32) return dv_tiles<COORDS, 1>(a, B, s);
  if (a.V <= 64) return dv_tiles<COORDS, 2>(a, B, s);
  return dv_tiles<COORDS, 4>(a, B, s);
}

bool bad_shape(int B, int Lo, int Li, int H, int V) {
  return B < 1 || Lo < 1 || Li < 1 || H < 1 || V < 1 || B > 65535 ||
         (Lo + TLO - 1) / TLO > 65535 || (Li + TLO - 1) / TLO > 65535;
}

bool bad_coords(int Lo, int dd, int tile_rows, const int* starts, int width) {
  // a block of TLO rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TLO == 0);
  return dd < 1 || dd > MAX_DIM || !tiles_ok || (starts != nullptr && width < 1);
}

Args dist_args(const float* dist, const float* scale, const float* values, const float* g,
               const float* stats, float* partial, float* out, int Lo, int Li, int H, int V) {
  return Args{dist, nullptr, nullptr, scale, values, g, stats, nullptr, partial, out,
              Lo, Li, H, V, 0, 0, Lo, 1};
}

Args coord_args(const float* mq, const float* mk, const float* scale, const float* values,
                const float* g, const float* stats, const int* starts, float* partial,
                float* out, int Lo, int Li, int H, int V, int dd, int width, int tile_rows) {
  return Args{nullptr, mq, mk, scale, values, g, stats, starts, partial, out,
              Lo, Li, H, V, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows};
}

}  // namespace

extern "C" int posatt_tf_bwd_dscale(const float* dist, const float* scale, const float* values,
                                    const float* g, const float* stats, float* partial,
                                    float* ds, int B, int Lo, int Li, int H, int V,
                                    void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  return launch_dscale<false>(dist_args(dist, scale, values, g, stats, partial, ds, Lo, Li, H, V),
                              B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_bwd_dv(const float* dist, const float* scale, const float* g,
                                const float* stats, float* dv, int B, int Lo, int Li, int H,
                                int V, void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  return launch_dv<false>(dist_args(dist, scale, nullptr, g, stats, nullptr, dv, Lo, Li, H, V),
                          B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_bwd_dscale(const float* mq, const float* mk, const float* scale,
                                          const float* values, const float* g,
                                          const float* stats, const int* starts, float* partial,
                                          float* ds, int B, int Lo, int Li, int H, int V, int dd,
                                          int width, int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, H, V) || bad_coords(Lo, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  return launch_dscale<true>(coord_args(mq, mk, scale, values, g, stats, starts, partial, ds,
                                        Lo, Li, H, V, dd, width, tile_rows),
                             B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_bwd_dv(const float* mq, const float* mk, const float* scale,
                                      const float* g, const float* stats, const int* starts,
                                      float* dv, int B, int Lo, int Li, int H, int V, int dd,
                                      int width, int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, H, V) || bad_coords(Lo, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  return launch_dv<true>(coord_args(mq, mk, scale, nullptr, g, stats, starts, nullptr, dv,
                                    Lo, Li, H, V, dd, width, tile_rows),
                         B, static_cast<cudaStream_t>(stream));
}
