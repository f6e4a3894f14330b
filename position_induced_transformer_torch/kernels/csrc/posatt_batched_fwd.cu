// Per-sample-mesh position attention, forward pass, hand-written for
// Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel _make_fwd_kernel, launched by _posatt_batched_raw
// (pallas_call at position_induced_transformer_tpu/kernels/
// posatt_batched.py:278). For sample b, output row i, head h and value
// column k, over the row's column window W (the whole key axis, or the
// band [start, start + width) of the extended key axis, start =
// starts[b, i / tile_rows], clipped to the key axis):
//
//   d[i,j]   = sum_c (q[i,c] - k[j,c])^2   (diff, square, sum in c order)
//   keep     = d <= thr[b,i]; or, without thr, d at or below the
//              keep_count-th smallest distinct value of the row; or every
//              column when keep_count >= L_in
//   dmin[i]  = min over W of d (the bare minimum)
//   p[h,i,j] = keep ? exp(-(d - dmin) * scale[h]) : 0
//   out[b, i, h*D + k] = sum_j p u[b,j,k] / max(sum_j p, 1e-30)
//
// With a non-null `stats` it also writes, per row, dmin, the keep
// threshold (+inf where every column is kept) and per head the reciprocal
// denominator, (B, H + 2, Lo): the residuals the backward kernels need.
//
// What bounds it on this card: its inputs and output are small (the
// coordinates, the values and the (B, Lo, H*D) output), so bytes bound it
// only where few columns are kept. It does 3*d operations per distance
// inspected and 2*H*D per kept entry; at the elasticity processor every
// entry is kept (972 x 972 per sample, D = 256), which puts it far above
// the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20 operations per byte): the f32
// CUDA-core rate bounds it there.
//
// What the design does about it:
// - Distances are recomputed from coordinates and never stored: a row of
//   the TPU kernel's resident (TLo, L_in) tile does not fit in shared
//   memory next to the values. Each distance is written with __fsub_rn /
//   __fmul_rn / __fadd_rn, so that no FMA contraction changes it: it is bit
//   for bit ops/distances.euclidean_sq's, which matters where the kernel's
//   own distances choose the kept set.
// - Two passes per block of 16 rows, as posatt_fixed_fwd.cu: one warp per
//   row finds dmin, the keep threshold and the per-head denominators; then
//   a loop over the window's columns stages final weights (all H heads from
//   one distance) and values in shared memory and contracts with a
//   register-tiled f32 product (4 rows x CPL columns per thread and head).
// - A block stays inside one band tile (16 divides the tile height), so
//   its window is block-uniform: the loops over columns run over the band
//   only, and a step whose weights are all zero skips its value loads and
//   its products (__syncthreads_or over the keep flags).
// - Ragged edges (rows, window columns past the extended key axis, value
//   columns past D) are masked by index; D may be any width.
// - Any head count: a block owns a group of HB <= 8 heads (ceil(H/8)
//   groups as even as can be; HB = H up to 8 heads), and a short last group
//   masks its missing heads.
// Tensor cores are not used: TF32 would not hold parity with the f32
// oracle. Double-buffered loads and a split of the column loop across
// blocks are work for later.
//
// The function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;  // coordinates per point
constexpr int TLO = 16;     // rows per block: divides every band tile height

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// A block owns the heads [h0, h0 + HB) below H, TLO = NWARPS*RPT rows of
// one sample and TN = 32*CPL value columns; warp w owns rows
// [w*RPT, w*RPT + RPT), lane c owns columns [c*CPL, c*CPL + CPL).
template <int HB, int NWARPS, int RPT, int CPL, int TLI>
__global__ void __launch_bounds__(NWARPS * 32)
posatt_batched_fwd_kernel(const float* __restrict__ mq,      // (B, Lo, dd)
                          const float* __restrict__ mk,      // (B, Li, dd)
                          const float* __restrict__ scale,   // (H)
                          const float* __restrict__ u,       // (B, Li, D)
                          const float* __restrict__ thr,     // (B, Lo) or null
                          const int* __restrict__ starts,    // (B, n_tiles) or null
                          float* __restrict__ out,           // (B, Lo, H*D)
                          float* __restrict__ stats,         // (B, H+2, Lo) or null
                          int H, int Lo, int Li, int D, int dd, int keep_count,
                          int width, int tile_rows, int n_tiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TN = 32 * CPL;
  static_assert(NWARPS * RPT == TLO, "rows per block");
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_p[HB][TLI][TLO];  // final weights
  __shared__ __align__(16) float s_u[TLI][TN];       // values
  __shared__ float s_q[TLO][MAX_DIM];                 // query coordinates
  __shared__ float s_dmin[TLO];
  __shared__ float s_thr[TLO];
  __shared__ float s_rden[HB][TLO];
  __shared__ float s_scale[HB];

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

  // the block's column window, the same for all its rows
  int j_begin = 0, j_end = Li;
  if (starts != nullptr) {
    const int s = starts[(size_t)b * n_tiles + row0 / tile_rows];
    j_begin = max(s, 0);
    j_end = min(s + width, Li);
  }

  if (tid < HB) s_scale[tid] = h0 + tid < H ? scale[h0 + tid] : 0.f;  // a missing head: finite
  for (int e = tid; e < TLO * MAX_DIM; e += THREADS) {
    const int r = e / MAX_DIM, c = e - r * MAX_DIM;
    const int i = row0 + r;
    s_q[r][c] = (i < Lo && c < dd) ? mq[((size_t)b * Lo + i) * dd + c] : 0.f;
  }
  __syncthreads();

  // ---- pass 1: dmin, keep threshold and denominators, one warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    const int i = row0 + r;
    if (i >= Lo) {  // never written; keeps nothing
      if (lane == 0) { s_dmin[r] = 0.f; s_thr[r] = -INFINITY; }
      if (lane < HB) s_rden[lane][r] = 0.f;
      continue;
    }
    float q[MAX_DIM];
#pragma unroll
    for (int c = 0; c < MAX_DIM; ++c) q[c] = s_q[r][c];
    float mn = INFINITY;
    for (int j = j_begin + lane; j < j_end; j += 32) mn = fminf(mn, sqdist(q, mkb + (size_t)j * dd, dd));
    mn = warp_min(mn);
    float t;
    if (thr != nullptr) {
      t = thr[(size_t)b * Lo + i];
    } else if (keep_count >= Li) {
      t = INFINITY;
    } else {  // keep_count - 1 masked-min passes: the c-th distinct value
      t = mn;
      for (int c = 1; c < keep_count; ++c) {
        float m2 = INFINITY;
        for (int j = j_begin + lane; j < j_end; j += 32) {
          const float d = sqdist(q, mkb + (size_t)j * dd, dd);
          if (d > t) m2 = fminf(m2, d);
        }
        t = warp_min(m2);
      }
    }
    float sm[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) sm[h] = 0.f;
    for (int j = j_begin + lane; j < j_end; j += 32) {
      const float d = sqdist(q, mkb + (size_t)j * dd, dd);
      if (d <= t) {
        const float x = __fsub_rn(d, mn);
#pragma unroll
        for (int h = 0; h < HB; ++h) sm[h] += expf(-x * s_scale[h]);
      }
    }
    const bool write_stats = stats != nullptr && ct == 0 && lane == 0;
    float* st = write_stats ? stats + (size_t)b * (H + 2) * Lo + i : nullptr;
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      const float rd = 1.f / fmaxf(warp_sum(sm[h]), 1e-30f);
      if (lane == 0) s_rden[h][r] = rd;
      if (write_stats && h0 + h < H) st[(size_t)(2 + h0 + h) * Lo] = rd;
    }
    if (lane == 0) { s_dmin[r] = mn; s_thr[r] = t; }
    if (write_stats && grp == 0) { st[0] = mn; st[Lo] = t; }
  }
  __syncthreads();

  // ---- pass 2: stage final weights and values per column step, contract
  const int rp = tid % TLO;  // the row this thread computes weights for
  const int ip = row0 + rp;
  float qp[MAX_DIM];
#pragma unroll
  for (int c = 0; c < MAX_DIM; ++c) qp[c] = s_q[rp][c];
  const float tp = s_thr[rp];
  const float dminp = s_dmin[rp];
  const int cu = tid % TN;  // the value column this thread stages
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
      for (int h = 0; h < HB; ++h) s_p[h][jj][rp] = k ? expf(-x * s_scale[h]) * s_rden[h][rp] : 0.f;
    }
    if (__syncthreads_or(any)) {  // block-uniform: the values only when needed
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
          float pv[RPT];
          lds<RPT>(&s_p[h][jj][warp * RPT], pv);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[h][r][c] = fmaf(pv[r], uv[c], acc[h][r][c]);
        }
      }
      __syncthreads();
    }
  }

  // ---- write the head-concat layout
  const int HD = H * D;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + warp * RPT + r;
    if (i >= Lo) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= D) continue;
      float* dst = out + ((size_t)b * Lo + i) * HD + (size_t)h0 * D + n;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        if (h0 + h < H) dst[h * D] = acc[h][r][c];
    }
  }
}

template <int HB, int CPL>
void launch_tiles(const float* mq, const float* mk, const float* scale, const float* u,
                  const float* thr, const int* starts, float* out, float* stats,
                  int H, int B, int Lo, int Li, int D, int dd, int keep_count, int width,
                  int tile_rows, cudaStream_t stream) {
  constexpr int TN = 32 * CPL;
  const dim3 grid((H + HB - 1) / HB * ((D + TN - 1) / TN), (Lo + TLO - 1) / TLO, B);
  const int n_tiles = (Lo + tile_rows - 1) / tile_rows;
  posatt_batched_fwd_kernel<HB, 4, 4, CPL, 32><<<grid, 128, 0, stream>>>(
      mq, mk, scale, u, thr, starts, out, stats, H, Lo, Li, D, dd, keep_count, width,
      tile_rows, n_tiles);
}

template <int HB>
int launch(const float* mq, const float* mk, const float* scale, const float* u,
           const float* thr, const int* starts, float* out, float* stats, int H, int B,
           int Lo, int Li, int D, int dd, int keep_count, int width, int tile_rows,
           cudaStream_t s) {
  // the value columns a block owns: 32, 64 or 128, the least that covers D
  // (D = 44 at the elasticity encoder, 256 after it)
  if (D <= 32)
    launch_tiles<HB, 1>(mq, mk, scale, u, thr, starts, out, stats, H, B, Lo, Li, D, dd, keep_count, width, tile_rows, s);
  else if (D <= 64)
    launch_tiles<HB, 2>(mq, mk, scale, u, thr, starts, out, stats, H, B, Lo, Li, D, dd, keep_count, width, tile_rows, s);
  else
    launch_tiles<HB, 4>(mq, mk, scale, u, thr, starts, out, stats, H, B, Lo, Li, D, dd, keep_count, width, tile_rows, s);
  return (int)cudaGetLastError();
}

// heads per block: at most 8, in ceil(H/8) groups as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

}  // namespace

extern "C" int posatt_batched_fwd(const float* mq, const float* mk, const float* scale,
                                  const float* u, const float* thr, const int* starts,
                                  float* out, float* stats, int H, int B, int Lo, int Li,
                                  int D, int dd, int keep_count, int width, int tile_rows,
                                  void* stream) {
  // a block of TLO rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TLO == 0);
  if (H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1 || dd < 1 || dd > MAX_DIM || !tiles_ok ||
      (starts != nullptr && width < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(HB) \
  launch<HB>(mq, mk, scale, u, thr, starts, out, stats, H, B, Lo, Li, D, dd, keep_count, width, tile_rows, s)
  switch (head_group(H)) {
    case 1: return LAUNCH(1);
    case 2: return LAUNCH(2);
    case 3: return LAUNCH(3);
    case 4: return LAUNCH(4);
    case 5: return LAUNCH(5);
    case 6: return LAUNCH(6);
    case 7: return LAUNCH(7);
    default: return LAUNCH(8);
  }
#undef LAUNCH
}
