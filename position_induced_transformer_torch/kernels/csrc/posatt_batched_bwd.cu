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
// Any head count: a dscale block owns a group of HB <= 8 heads (ceil(H/8)
// groups as even as can be; HB = H up to 8 heads), and a du block, whose
// sum runs over all heads, walks the groups in turn (above 8 heads only:
// up to 8 its code is that of one group). A short last group masks its
// missing heads.
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

// A block owns the heads [h0, h0 + HB) below H, TLO rows of one sample and
// TN = 32*CPL value columns.
template <int HB, int NWARPS, int RPT, int CPL, int TLI>
__global__ void __launch_bounds__(NWARPS * 32)
dscale_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
              const float* __restrict__ scale, const float* __restrict__ u,
              const float* __restrict__ g, const float* __restrict__ stats,
              const int* __restrict__ starts, float* __restrict__ partial,
              int H, int Lo, int Li, int D, int dd, int width, int tile_rows, int n_tiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TN = 32 * CPL;
  static_assert(NWARPS * RPT == TLO, "rows per block");
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_w[HB][TLI][TLO];  // Q = P (-d - v)
  __shared__ __align__(16) float s_u[TLI][TN];
  __shared__ float s_q[TLO][MAX_DIM];
  __shared__ float s_dmin[TLO];
  __shared__ float s_thr[TLO];
  __shared__ float s_rden[HB][TLO];
  __shared__ float s_v[HB][TLO];  // sum_j P (-d)
  __shared__ float s_scale[HB];
  __shared__ float s_red[HB][NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TLO;
  const int n_ct = (D + TN - 1) / TN;
  const int grp = blockIdx.x / n_ct;  // the head group; 0 up to 8 heads
  const int ct = blockIdx.x - grp * n_ct;
  const int col0 = ct * TN;
  const int h0 = grp * HB;
  const float* mkb = mk + (size_t)b * Li * dd;
  const float* ub = u + (size_t)b * Li * D;
  const float* stb = stats + (size_t)b * (H + 2) * Lo;
  int j_begin, j_end;
  window(starts, b, row0 / tile_rows, n_tiles, width, Li, &j_begin, &j_end);

  if (tid < HB) s_scale[tid] = h0 + tid < H ? scale[h0 + tid] : 0.f;  // a missing head: finite
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
  for (int e = tid; e < HB * TLO; e += THREADS) {
    const int h = e / TLO, r = e - h * TLO;
    const int i = row0 + r;
    s_rden[h][r] = i < Lo && h0 + h < H ? stb[(size_t)(2 + h0 + h) * Lo + i] : 0.f;
  }
  __syncthreads();

  // ---- prologue: v_h[i] = sum_j P_h[i,j] * (-d_ij), one warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    float q[MAX_DIM];
#pragma unroll
    for (int c = 0; c < MAX_DIM; ++c) q[c] = s_q[r][c];
    const float t = s_thr[r], mn = s_dmin[r];
    float v[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) v[h] = 0.f;
    for (int j = j_begin + lane; j < j_end; j += 32) {
      const float d = sqdist(q, mkb + (size_t)j * dd, dd);
      if (d <= t) {
        const float x = __fsub_rn(d, mn);
#pragma unroll
        for (int h = 0; h < HB; ++h) v[h] += expf(-x * s_scale[h]) * s_rden[h][r] * -d;
      }
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) {
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

  float acc[HB][RPT][CPL];
#pragma unroll
  for (int h = 0; h < HB; ++h)
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
      for (int h = 0; h < HB; ++h)
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
        for (int h = 0; h < HB; ++h) {
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
  float part[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) part[h] = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + warp * RPT + r;
    if (i >= Lo) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= D) continue;
      const float* gp = g + ((size_t)b * Lo + i) * HD + (size_t)h0 * D + n;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        if (h0 + h < H) part[h] = fmaf(acc[h][r][c], gp[h * D], part[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    part[h] = warp_sum(part[h]);
    if (lane == 0) s_red[h][warp] = part[h];
  }
  __syncthreads();
  if (tid < HB && h0 + tid < H) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += s_red[tid][w];
    const size_t per_sample = (size_t)n_ct * gridDim.y;
    partial[((size_t)b * per_sample + (size_t)blockIdx.y * n_ct + ct) * H + h0 + tid] = s;
  }
}

// one block per (sample, head), a warp; each lane sums a fixed strided set
// of partials, then a fixed butterfly: the same bits on every run
__global__ void __launch_bounds__(32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ ds, int H,
                    int nparts) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += partial[((size_t)b * nparts + p) * H + h];
  s = warp_sum(s);
  if (lane == 0) ds[(size_t)b * H + h] = s;
}

// ------------------------------------------------------------------- du

// A block owns TLO key rows j of one sample and TN = 32*CPL value columns;
// the contraction runs over (i, h) pairs of one group of HB heads at a
// time, KSTEP of them (TI = KSTEP/HB rows i) a step: 32 pairs for HB = 1,
// 2, 4, 8. Up to 8 heads one group holds them all (GROUPED false: the loop
// over groups compiles away).
template <int HB, bool GROUPED, int NWARPS, int RPT, int CPL>
__global__ void __launch_bounds__(NWARPS * 32)
du_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
          const float* __restrict__ scale, const float* __restrict__ g,
          const float* __restrict__ stats, const int* __restrict__ starts,
          float* __restrict__ du, int H, int Lo, int Li, int D, int dd, int width,
          int tile_rows, int n_tiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TN = 32 * CPL;
  constexpr int TI = 32 / HB;
  constexpr int KSTEP = TI * HB;
  static_assert(NWARPS * RPT == TLO, "key rows per block");
  static_assert(THREADS % TN == 0, "tile shape");
  __shared__ __align__(16) float s_p[KSTEP][TLO];  // pair kk = ii*HB + h
  __shared__ __align__(16) float s_g[KSTEP][TN];
  __shared__ float s_k[TLO][MAX_DIM];  // the block's key coordinates
  __shared__ float s_scale[HB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int j0 = blockIdx.y * TLO;
  const int col0 = blockIdx.x * TN;
  const int HD = H * D;
  const float* mqb = mq + (size_t)b * Lo * dd;
  const float* stb = stats + (size_t)b * (H + 2) * Lo;

  for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
    const int r = e / MAX_DIM, c = e - r * MAX_DIM;
    const int j = j0 + r;
    s_k[r][c] = (j < Li && c < dd) ? mk[((size_t)b * Li + j) * dd + c] : 0.f;
  }

  const int cg = tid % TN;  // the column of G this thread stages
  const int ng = col0 + cg;
  const bool col_ok = ng < D;
  const float* gp = g + (size_t)b * Lo * HD + (col_ok ? ng : 0);

  float acc[RPT][CPL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  for (int h0 = 0; h0 < (GROUPED ? H : HB); h0 += HB) {
    if (GROUPED) __syncthreads();  // the last group's steps are done with s_scale
    if (tid < HB) s_scale[tid] = (!GROUPED || h0 + tid < H) ? scale[h0 + tid] : 0.f;
    __syncthreads();
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
          for (int h = 0; h < HB; ++h) {
            const int hh = h0 + h;  // a missing head weighs 0
            s_p[ii * HB + h][jj] = k && (!GROUPED || hh < H)
                                       ? expf(-x * s_scale[h]) * stb[(size_t)(2 + hh) * Lo + i]
                                       : 0.f;
          }
        }
        if (__syncthreads_or(any)) {  // block-uniform: G only when needed
#pragma unroll
          for (int q = 0; q < (KSTEP * TN + THREADS - 1) / THREADS; ++q) {
            const int kk = tid / TN + q * (THREADS / TN);
            if ((KSTEP * TN) % THREADS == 0 || kk < KSTEP) {  // whole steps for HB = 1, 2, 4, 8
              const int ii = kk / HB, h = h0 + kk - ii * HB;
              const int i = i0 + ii;
              s_g[kk][cg] = (col_ok && i < i_end && (!GROUPED || h < H))
                                ? gp[(size_t)i * HD + h * D]
                                : 0.f;
            }
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

template <int HB, int CPL>
int dscale_tiles(const float* mq, const float* mk, const float* scale, const float* u,
                 const float* g, const float* stats, const int* starts, float* partial,
                 float* ds, int H, int B, int Lo, int Li, int D, int dd, int width,
                 int tile_rows, cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const int n_ct = (D + TN - 1) / TN;
  const dim3 grid((H + HB - 1) / HB * n_ct, (Lo + TLO - 1) / TLO, B);
  const int n_tiles = (Lo + tile_rows - 1) / tile_rows;
  dscale_kernel<HB, 4, 4, CPL, 32><<<grid, 128, 0, s>>>(
      mq, mk, scale, u, g, stats, starts, partial, H, Lo, Li, D, dd, width, tile_rows, n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<dim3(B, H), 32, 0, s>>>(partial, ds, H, (int)(n_ct * grid.y));
  return (int)cudaGetLastError();
}

// the value columns a block owns: 32, 64 or 128, the least that covers D;
// the partial buffer must hold B * ceil(Lo/16) * ceil(D/32) * H floats
template <int HB>
int launch_dscale(const float* mq, const float* mk, const float* scale, const float* u,
                  const float* g, const float* stats, const int* starts, float* partial,
                  float* ds, int H, int B, int Lo, int Li, int D, int dd, int width,
                  int tile_rows, cudaStream_t s) {
  if (D <= 32)
    return dscale_tiles<HB, 1>(mq, mk, scale, u, g, stats, starts, partial, ds, H, B, Lo, Li, D, dd, width, tile_rows, s);
  if (D <= 64)
    return dscale_tiles<HB, 2>(mq, mk, scale, u, g, stats, starts, partial, ds, H, B, Lo, Li, D, dd, width, tile_rows, s);
  return dscale_tiles<HB, 4>(mq, mk, scale, u, g, stats, starts, partial, ds, H, B, Lo, Li, D, dd, width, tile_rows, s);
}

template <int HB, bool GROUPED, int CPL>
int du_tiles(const float* mq, const float* mk, const float* scale, const float* g,
             const float* stats, const int* starts, float* du, int H, int B, int Lo, int Li,
             int D, int dd, int width, int tile_rows, cudaStream_t s) {
  constexpr int TN = 32 * CPL;
  const dim3 grid((D + TN - 1) / TN, (Li + TLO - 1) / TLO, B);
  const int n_tiles = (Lo + tile_rows - 1) / tile_rows;
  du_kernel<HB, GROUPED, 4, 4, CPL><<<grid, 128, 0, s>>>(
      mq, mk, scale, g, stats, starts, du, H, Lo, Li, D, dd, width, tile_rows, n_tiles);
  return (int)cudaGetLastError();
}

// G is staged per head, so a staged G value feeds H times fewer products
// than a staged value does in the forward: at most 64 columns per block,
// for more blocks to hide its loads
template <int HB, bool GROUPED>
int launch_du(const float* mq, const float* mk, const float* scale, const float* g,
              const float* stats, const int* starts, float* du, int H, int B, int Lo, int Li,
              int D, int dd, int width, int tile_rows, cudaStream_t s) {
  if (D <= 32)
    return du_tiles<HB, GROUPED, 1>(mq, mk, scale, g, stats, starts, du, H, B, Lo, Li, D, dd, width, tile_rows, s);
  return du_tiles<HB, GROUPED, 2>(mq, mk, scale, g, stats, starts, du, H, B, Lo, Li, D, dd, width, tile_rows, s);
}

// heads per dscale block or per group of du steps: at most 8, in
// ceil(H/8) groups as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

// return fn<head_group(H)>(...)
#define BY_HEAD_GROUP(fn, ...)          \
  switch (head_group(H)) {              \
    case 1: return fn<1>(__VA_ARGS__);  \
    case 2: return fn<2>(__VA_ARGS__);  \
    case 3: return fn<3>(__VA_ARGS__);  \
    case 4: return fn<4>(__VA_ARGS__);  \
    case 5: return fn<5>(__VA_ARGS__);  \
    case 6: return fn<6>(__VA_ARGS__);  \
    case 7: return fn<7>(__VA_ARGS__);  \
    default: return fn<8>(__VA_ARGS__); \
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
  if (H < 1 || bad_shape(B, Lo, Li, D, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_HEAD_GROUP(launch_dscale, mq, mk, scale, u, g, stats, starts, partial, ds, H, B, Lo, Li, D,
                dd, width, tile_rows, s)
}

extern "C" int posatt_batched_bwd_du(const float* mq, const float* mk, const float* scale,
                                     const float* g, const float* stats, const int* starts,
                                     float* du, int H, int B, int Lo, int Li, int D, int dd,
                                     int width, int tile_rows, void* stream) {
  if (H < 1 || bad_shape(B, Lo, Li, D, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DU(HB, GROUPED) \
  launch_du<HB, GROUPED>(mq, mk, scale, g, stats, starts, du, H, B, Lo, Li, D, dd, width, tile_rows, s)
  switch (H) {  // up to 8 heads one group holds them all
    case 1: return DU(1, false);
    case 2: return DU(2, false);
    case 3: return DU(3, false);
    case 4: return DU(4, false);
    case 5: return DU(5, false);
    case 6: return DU(6, false);
    case 7: return DU(7, false);
    case 8: return DU(8, false);
    default: break;
  }
  switch (head_group(H)) {  // 5 to 8 heads a group
    case 5: return DU(5, true);
    case 6: return DU(6, true);
    case 7: return DU(7, true);
    default: return DU(8, true);
  }
#undef DU
}
