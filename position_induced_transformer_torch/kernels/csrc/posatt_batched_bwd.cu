// Per-sample-mesh position attention, backward pass, hand-written for
// Hopper (sm_90a), float32 throughout. Two C entry points that together
// replace the TPU kernel _make_bwd_kernel, launched by
// _posatt_batched_bwd_raw (pallas_call at position_induced_transformer_tpu/
// kernels/posatt_batched.py:415):
//
//   posatt_batched_bwd_dscale  -> d(loss)/d(scale) per sample, (B, H)
//   posatt_batched_bwd_du      -> d(loss)/d(values), (B, Li, D)
//
// Notation as in posatt_batched_fwd.cu: coordinates mq (B, Lo, dd) and mk
// (B, Li, dd) on the extended key axis, scale (H), values u (B, Li, D),
// the output's cotangent g (B, Lo, H*D), the optional band (starts,
// width, tile_rows), and the forward's row statistics stats (B, H+2, Lo):
// dmin, the keep threshold t and the reciprocal denominators rden_h. On a
// kept entry (d <= t, inside the row's window)
//
//   P_h[i,j] = exp(-(d[i,j] - dmin[i]) * scale[h]) * rden_h[i]
//
// and P is exactly 0 elsewhere. Distances are recomputed from coordinates
// in the forward's op order, with no FMA contraction, so the kept sets are
// the forward's.
//
// The TPU kernel walks the row tiles of a sample in order, carrying dU in
// VMEM and dScale in SMEM across grid steps. Blocks on the card run in
// parallel and carry nothing, so the work is split:
//
// posatt_batched_bwd_dscale: the TPU kernel sums, per row, r = sum_j P T,
// v = sum_j P (-d), w = sum_j P T (-d) with T = G_h U^T, and returns
// sum_i (w_i - r_i v_i). That is
//
//   ds[b,h] = sum_{i,j} P (-d - v_h[i]) T[i,j]
//           = sum_{i,k} G_h[i,k] * (Q_h U)[i,k],   Q_h = P_h (-d - v_h)
//
// so the product with U is the forward's contraction with weights Q: a
// prologue computes v per row (one warp per row), the column loop stages
// Q and U and contracts, and the epilogue multiplies by G and reduces to
// one partial per block and head. A second kernel sums each sample's
// partials in a fixed order: the same bits on every run, no float atomics.
//
// posatt_batched_bwd_du: dU = sum_h P_h^T G_h, the contraction transposed.
// A block owns 16 key rows j of one sample and a tile of value columns;
// it walks only the band tiles whose window meets its rows (every row
// without a band), stages P recomputed from the statistics and the
// matching G in shared memory per step of (i, h) pairs, and skips a step
// without a kept entry before loading G.
//
// What bounds them on this card: each does 2*H*D operations per kept entry
// plus 3*dd per distance inspected, and moves the coordinates, values,
// statistics and cotangent once. At the elasticity processor (all 972
// columns kept, D = 256) the f32 CUDA-core rate bounds both; at the banded
// encoder and decoder (about 20 of 972 columns kept) bytes do, and the
// kernels inspect every column of the band. Tensor cores are not used (TF32
// would not hold parity with the f32 oracle), there is no fast math, and
// ragged edges are masked by index.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;
constexpr int TLO = 16;  // rows per dscale block, key rows per du block

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

// the window [*j_begin, *j_end) of band tile t of sample b; the whole key
// axis without a band
__device__ __forceinline__ void window(const int* starts, int b, int t, int n_tiles,
                                       int width, int Li, int* j_begin, int* j_end) {
  if (starts == nullptr) { *j_begin = 0; *j_end = Li; return; }
  const int s = starts[(size_t)b * n_tiles + t];
  *j_begin = max(s, 0);
  *j_end = min(s + width, Li);
}

// --------------------------------------------------------------- dscale

template <int H, int NWARPS, int RPT, int CPL, int TLI>
__global__ void __launch_bounds__(NWARPS * 32)
dscale_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
              const float* __restrict__ scale, const float* __restrict__ u,
              const float* __restrict__ g, const float* __restrict__ stats,
              const int* __restrict__ starts, float* __restrict__ partial,
              int Lo, int Li, int D, int dd, int width, int tile_rows, int n_tiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TN = 32 * CPL;
  static_assert(NWARPS * RPT == TLO, "rows per block");
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_w[H][TLI][TLO];  // Q = P (-d - v)
  __shared__ __align__(16) float s_u[TLI][TN];
  __shared__ float s_q[TLO][MAX_DIM];
  __shared__ float s_dmin[TLO];
  __shared__ float s_thr[TLO];
  __shared__ float s_rden[H][TLO];
  __shared__ float s_v[H][TLO];  // sum_j P (-d)
  __shared__ float s_scale[H];
  __shared__ float s_red[H][NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TLO;
  const int col0 = blockIdx.x * TN;
  const float* mkb = mk + (size_t)b * Li * dd;
  const float* ub = u + (size_t)b * Li * D;
  const float* stb = stats + (size_t)b * (H + 2) * Lo;
  int j_begin, j_end;
  window(starts, b, row0 / tile_rows, n_tiles, width, Li, &j_begin, &j_end);

  if (tid < H) s_scale[tid] = scale[tid];
  for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
    const int r = e / MAX_DIM, c = e - r * MAX_DIM;
    const int i = row0 + r;
    s_q[r][c] = (i < Lo && c < dd) ? mq[((size_t)b * Lo + i) * dd + c] : 0.f;
  }
  for (int r = tid; r < TLO; r += THREADS) {
    const int i = row0 + r;
    s_dmin[r] = i < Lo ? stb[i] : 0.f;
    s_thr[r] = i < Lo ? stb[Lo + i] : -INFINITY;  // a padded row keeps nothing
  }
  for (int e = tid; e < H * TLO; e += THREADS) {
    const int h = e / TLO, r = e - h * TLO;
    const int i = row0 + r;
    s_rden[h][r] = i < Lo ? stb[(size_t)(2 + h) * Lo + i] : 0.f;
  }
  __syncthreads();

  // ---- prologue: v_h[i] = sum_j P_h[i,j] * (-d_ij), one warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    float q[MAX_DIM];
#pragma unroll
    for (int c = 0; c < MAX_DIM; ++c) q[c] = s_q[r][c];
    const float t = s_thr[r], mn = s_dmin[r];
    float v[H];
#pragma unroll
    for (int h = 0; h < H; ++h) v[h] = 0.f;
    for (int j = j_begin + lane; j < j_end; j += 32) {
      const float d = sqdist(q, mkb + (size_t)j * dd, dd);
      if (d <= t) {
        const float x = __fsub_rn(d, mn);
#pragma unroll
        for (int h = 0; h < H; ++h) v[h] += expf(-x * s_scale[h]) * s_rden[h][r] * -d;
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      v[h] = warp_sum(v[h]);
      if (lane == 0) s_v[h][r] = v[h];
    }
  }
  __syncthreads();

  // ---- Y = Q U over column steps, skipping steps without a kept entry
  const int rp = tid % TLO;
  const int ip = row0 + rp;
  float qp[MAX_DIM];
#pragma unroll
  for (int c = 0; c < MAX_DIM; ++c) qp[c] = s_q[rp][c];
  const float tp = s_thr[rp];
  const float dminp = s_dmin[rp];
  const int cu = tid % TN;
  const int nu = col0 + cu;
  const bool col_ok = nu < D;

  float acc[H][RPT][CPL];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[h][r][c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += TLI) {
    int any = 0;
#pragma unroll
    for (int q = 0; q < TLI * TLO / THREADS; ++q) {
      const int jj = tid / TLO + q * (THREADS / TLO);
      const int j = j0 + jj;
      const bool ok = ip < Lo && j < j_end;
      const float d = ok ? sqdist(qp, mkb + (size_t)j * dd, dd) : 0.f;
      const bool k = ok && d <= tp;
      any |= k;
      const float x = __fsub_rn(d, dminp);
#pragma unroll
      for (int h = 0; h < H; ++h)
        s_w[h][jj][rp] = k ? expf(-x * s_scale[h]) * s_rden[h][rp] * (-d - s_v[h][rp]) : 0.f;
    }
    if (__syncthreads_or(any)) {
#pragma unroll
      for (int q = 0; q < TLI * TN / THREADS; ++q) {
        const int jj = tid / TN + q * (THREADS / TN);
        const int j = j0 + jj;
        s_u[jj][cu] = (col_ok && j < j_end) ? ub[(size_t)j * D + nu] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TLI; ++jj) {
        float uv[CPL];
        lds<CPL>(&s_u[jj][lane * CPL], uv);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float wv[RPT];
          lds<RPT>(&s_w[h][jj][warp * RPT], wv);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[h][r][c] = fmaf(wv[r], uv[c], acc[h][r][c]);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: sum over the block's (i, k) of G * Y, per head
  const int HD = H * D;
  float part[H];
#pragma unroll
  for (int h = 0; h < H; ++h) part[h] = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + warp * RPT + r;
    if (i >= Lo) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= D) continue;
      const float* gp = g + ((size_t)b * Lo + i) * HD + n;
#pragma unroll
      for (int h = 0; h < H; ++h) part[h] = fmaf(acc[h][r][c], gp[h * D], part[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    part[h] = warp_sum(part[h]);
    if (lane == 0) s_red[h][warp] = part[h];
  }
  __syncthreads();
  if (tid < H) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += s_red[tid][w];
    const size_t per_sample = (size_t)gridDim.x * gridDim.y;
    partial[((size_t)b * per_sample + (size_t)blockIdx.y * gridDim.x + blockIdx.x) * H + tid] = s;
  }
}

// one block per sample, one warp per head; each lane sums a fixed strided
// set of partials, then a fixed butterfly: the same bits on every run
template <int H>
__global__ void __launch_bounds__(H * 32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ ds, int nparts) {
  const int lane = threadIdx.x & 31;
  const int h = threadIdx.x >> 5;
  const int b = blockIdx.x;
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += partial[((size_t)b * nparts + p) * H + h];
  s = warp_sum(s);
  if (lane == 0) ds[(size_t)b * H + h] = s;
}

// ------------------------------------------------------------------- du

// A block owns TLO key rows j of one sample and TN = 32*CPL value columns;
// the contraction runs over (i, h) pairs, KSTEP of them (KSTEP/H rows i) a
// step.
template <int H, int NWARPS, int RPT, int CPL, int KSTEP>
__global__ void __launch_bounds__(NWARPS * 32)
du_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
          const float* __restrict__ scale, const float* __restrict__ g,
          const float* __restrict__ stats, const int* __restrict__ starts,
          float* __restrict__ du, int Lo, int Li, int D, int dd, int width,
          int tile_rows, int n_tiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TN = 32 * CPL;
  constexpr int TI = KSTEP / H;
  static_assert(NWARPS * RPT == TLO, "key rows per block");
  static_assert(KSTEP % H == 0, "whole rows per step");
  static_assert(THREADS % TN == 0 && (KSTEP * TN) % THREADS == 0, "tile shape");
  __shared__ __align__(16) float s_p[KSTEP][TLO];  // pair kk = ii*H + h
  __shared__ __align__(16) float s_g[KSTEP][TN];
  __shared__ float s_k[TLO][MAX_DIM];  // the block's key coordinates
  __shared__ float s_scale[H];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int j0 = blockIdx.y * TLO;
  const int col0 = blockIdx.x * TN;
  const int HD = H * D;
  const float* mqb = mq + (size_t)b * Lo * dd;
  const float* stb = stats + (size_t)b * (H + 2) * Lo;

  if (tid < H) s_scale[tid] = scale[tid];
  for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
    const int r = e / MAX_DIM, c = e - r * MAX_DIM;
    const int j = j0 + r;
    s_k[r][c] = (j < Li && c < dd) ? mk[((size_t)b * Li + j) * dd + c] : 0.f;
  }
  __syncthreads();

  const int cg = tid % TN;  // the column of G this thread stages
  const int ng = col0 + cg;
  const bool col_ok = ng < D;
  const float* gp = g + (size_t)b * Lo * HD + (col_ok ? ng : 0);

  float acc[RPT][CPL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  const int n_t = starts != nullptr ? n_tiles : 1;
  for (int t = 0; t < n_t; ++t) {
    int w_begin, w_end;
    window(starts, b, t, n_tiles, width, Li, &w_begin, &w_end);
    // the columns of this tile's window that are the block's key rows
    const int jb = max(w_begin, j0), je = min(w_end, min(j0 + TLO, Li));
    if (jb >= je) continue;  // block-uniform
    const int i_begin = starts != nullptr ? t * tile_rows : 0;
    const int i_end = starts != nullptr ? min((t + 1) * tile_rows, Lo) : Lo;
    for (int i0 = i_begin; i0 < i_end; i0 += TI) {
      int any = 0;
      for (int e = tid; e < TI * TLO; e += THREADS) {
        const int ii = e / TLO, jj = e - ii * TLO;
        const int i = i0 + ii, j = j0 + jj;
        const bool ok = i < i_end && j >= jb && j < je;
        float q[MAX_DIM];
#pragma unroll
        for (int c = 0; c < MAX_DIM; ++c) q[c] = (ok && c < dd) ? mqb[(size_t)i * dd + c] : 0.f;
        const float d = ok ? sqdist(q, s_k[jj], dd) : 0.f;
        const bool k = ok && d <= stb[Lo + i];
        any |= k;
        const float x = k ? __fsub_rn(d, stb[i]) : 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h)
          s_p[ii * H + h][jj] = k ? expf(-x * s_scale[h]) * stb[(size_t)(2 + h) * Lo + i] : 0.f;
      }
      if (__syncthreads_or(any)) {  // block-uniform: G only when needed
#pragma unroll
        for (int q = 0; q < KSTEP * TN / THREADS; ++q) {
          const int kk = tid / TN + q * (THREADS / TN);
          const int ii = kk / H, h = kk - ii * H;
          const int i = i0 + ii;
          s_g[kk][cg] = (col_ok && i < i_end) ? gp[(size_t)i * HD + h * D] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KSTEP; ++kk) {
          float gv[CPL], pv[RPT];
          lds<CPL>(&s_g[kk][lane * CPL], gv);
          lds<RPT>(&s_p[kk][warp * RPT], pv);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(pv[r], gv[c], acc[r][c]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = j0 + warp * RPT + r;
    if (j >= Li) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= D) continue;
      du[((size_t)b * Li + j) * D + n] = acc[r][c];
    }
  }
}

// --------------------------------------------------------------- launch

template <int H, int CPL>
int dscale_tiles(const float* mq, const float* mk, const float* scale, const float* u,
                 const float* g, const float* stats, const int* starts, float* partial,
                 float* ds, int B, int Lo, int Li, int D, int dd, int width, int tile_rows,
                 cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const dim3 grid((D + TN - 1) / TN, (Lo + TLO - 1) / TLO, B);
  const int n_tiles = (Lo + tile_rows - 1) / tile_rows;
  dscale_kernel<H, 4, 4, CPL, 32><<<grid, 128, 0, s>>>(
      mq, mk, scale, u, g, stats, starts, partial, Lo, Li, D, dd, width, tile_rows, n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<H><<<B, H * 32, 0, s>>>(partial, ds, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// the value columns a block owns: 32, 64 or 128, the least that covers D;
// the partial buffer must hold B * ceil(Lo/16) * ceil(D/32) * H floats
template <int H>
int launch_dscale(const float* mq, const float* mk, const float* scale, const float* u,
                  const float* g, const float* stats, const int* starts, float* partial,
                  float* ds, int B, int Lo, int Li, int D, int dd, int width, int tile_rows,
                  cudaStream_t s) {
  if (D <= 32)
    return dscale_tiles<H, 1>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
  if (D <= 64)
    return dscale_tiles<H, 2>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
  return dscale_tiles<H, 4>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
}

template <int H, int CPL>
int du_tiles(const float* mq, const float* mk, const float* scale, const float* g,
             const float* stats, const int* starts, float* du, int B, int Lo, int Li,
             int D, int dd, int width, int tile_rows, cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const dim3 grid((D + TN - 1) / TN, (Li + TLO - 1) / TLO, B);
  const int n_tiles = (Lo + tile_rows - 1) / tile_rows;
  du_kernel<H, 4, 4, CPL, 32><<<grid, 128, 0, s>>>(
      mq, mk, scale, g, stats, starts, du, Lo, Li, D, dd, width, tile_rows, n_tiles);
  return (int)cudaGetLastError();
}

// G is staged per head, so a staged G value feeds H times fewer products
// than a staged value does in the forward: at most 64 columns per block,
// for more blocks to hide its loads
template <int H>
int launch_du(const float* mq, const float* mk, const float* scale, const float* g,
              const float* stats, const int* starts, float* du, int B, int Lo, int Li,
              int D, int dd, int width, int tile_rows, cudaStream_t s) {
  if (D <= 32)
    return du_tiles<H, 1>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
  return du_tiles<H, 2>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
}

bool bad_shape(int B, int Lo, int Li, int D, int dd, int tile_rows, const int* starts,
               int width) {
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TLO == 0);
  return B < 1 || Lo < 1 || Li < 1 || D < 1 || dd < 1 || dd > MAX_DIM || !tiles_ok ||
         (starts != nullptr && width < 1);
}

}  // namespace

extern "C" int posatt_batched_bwd_dscale(const float* mq, const float* mk, const float* scale,
                                         const float* u, const float* g, const float* stats,
                                         const int* starts, float* partial, float* ds, int H,
                                         int B, int Lo, int Li, int D, int dd, int width,
                                         int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, D, dd, tile_rows, starts, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: return launch_dscale<1>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
    case 2: return launch_dscale<2>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
    case 4: return launch_dscale<4>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
    case 8: return launch_dscale<8>(mq, mk, scale, u, g, stats, starts, partial, ds, B, Lo, Li, D, dd, width, tile_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int posatt_batched_bwd_du(const float* mq, const float* mk, const float* scale,
                                     const float* g, const float* stats, const int* starts,
                                     float* du, int H, int B, int Lo, int Li, int D, int dd,
                                     int width, int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, D, dd, tile_rows, starts, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: return launch_du<1>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
    case 2: return launch_du<2>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
    case 4: return launch_du<4>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
    case 8: return launch_du<8>(mq, mk, scale, g, stats, starts, du, B, Lo, Li, D, dd, width, tile_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
