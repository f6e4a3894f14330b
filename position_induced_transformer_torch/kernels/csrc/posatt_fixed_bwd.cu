// Fixed-mesh position attention, backward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Three C entry points, each the port of one
// TPU kernel of position_induced_transformer_tpu/kernels/posatt_pallas.py:
//
//   posatt_stats       <- _posatt_stats
//   posatt_bwd_dscale  <- _posatt_bwd_dscale
//   posatt_bwd_du      <- _posatt_bwd_du
//
// Notation, as in posatt_fixed_fwd.cu: dist (Lo, Li), thr (Lo), scale (H),
// values u (B, Li, D), the forward's output cotangent g (B, Lo, H*D), and
// the batch-folded column n = b*D + k (N = B*D columns). An entry (i, j) is
// kept when dist[i,j] <= thr[i] and dist[i,j] is finite; on kept entries
//
//   P_h[i,j] = exp(-scale[h] * dist[i,j] - M_h[i]) / L_h[i]
//
// and P is exactly 0 elsewhere, with M, L the final softmax row max and
// normaliser of the forward's masked logits (masked logit = -1e38, finite).
//
// posatt_stats writes M and L, (H, Lo) each. One warp per row reads the
// row once for its maximum and once more (from L1) for the normaliser, all
// H heads from each distance read: the same first pass as the forward
// kernel's, so M and L are the numbers the forward used. Bound: reading
// the distances (bytes).
//
// posatt_bwd_dscale writes d(loss)/d(scale), (H). The TPU kernel sums, per
// row, r = sum_j P T, v = sum_j P (-d), w = sum_j P T (-d) with
// T = G U^T, and returns sum_i (w_i - r_i v_i). That is
//
//   ds_h = sum_{i,j} P_h[i,j] (-d_ij - v_h[i]) T_h[i,j]
//        = sum_{i,n} G_h[i,n] * (Q_h U)[i,n],   Q_h[i,j] = P_h[i,j] (-d_ij - v_h[i])
//
// so this kernel computes the product with U inside itself, as the
// forward does (weights Q staged in shared memory, a register-tiled f32
// contraction over j), multiplies by G in its epilogue and reduces. The
// centred distance (-d - v) cancels per entry, not across the final sum.
// A prologue computes v per row (one warp per row). Each block writes one
// partial per head; a second, one-block kernel sums the partials in a
// fixed order, so two runs give the same bits (no float atomics).
//
// posatt_bwd_du writes dU (B, Li, D) = sum_h P_h^T G_h: the forward's
// contraction transposed. A block owns TJ rows j of dU and TN columns n,
// streams over the rows i of dist in steps of KSTEP (i, h) pairs, stages
// P recomputed from (M, L) and the matching G values in shared memory and
// accumulates straight into the (B, Li, D) layout.
//
// What bounds them on this card: #3 and #4 do 2*H*B*D f32 operations per
// KEPT entry and must read the distances, G and U (or write dU) once; at
// the Burgers processor shape (every entry kept, B*D = 512) the f32
// CUDA-core rate bounds them, at the masked encoder and decoder shapes the
// bytes do. Both kernels are dense within a tile, but skip a whole tile
// step when it holds no kept entry (__syncthreads_or over the staged keep
// flags, before the G or U tile is loaded): at the masked shapes most
// steps hold none. Tensor cores are not used (TF32 would not hold parity
// with the f32 oracle), there is no fast math, and ragged edges are
// masked by index, with no padded copy.
//
// Any head count: the stats and dscale kernels give a block a group of
// HB <= 8 heads (ceil(H/8) groups as even as can be, one per grid index;
// HB = H up to 8 heads), and a du block, whose sum runs over all heads,
// walks the groups in turn. A short last group masks its missing heads.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG = -1e38f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool kept(float d, float thr) {
  return (d <= thr) && (d < INFINITY);
}

__device__ __forceinline__ float logit(float d, float thr, float s) {
  return kept(d, thr) ? -s * d : NEG;
}

// N consecutive floats from shared memory; 4 of them as one vector load
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

// ---------------------------------------------------------------- stats

constexpr int STATS_WARPS = 8;

template <int HB>
__global__ void __launch_bounds__(STATS_WARPS * 32)
posatt_stats_kernel(const float* __restrict__ dist,   // (Lo, Li)
                    const float* __restrict__ thr,    // (Lo)
                    const float* __restrict__ scale,  // (H)
                    float* __restrict__ M,            // (H, Lo)
                    float* __restrict__ L,            // (H, Lo)
                    int H, int Lo, int Li) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * STATS_WARPS + (threadIdx.x >> 5);
  const int h0 = blockIdx.y * HB;
  if (i >= Lo) return;  // the whole warp leaves together
  const float t = thr[i];
  const float* drow = dist + (size_t)i * Li;
  float s[HB], mx[HB], sm[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    s[h] = h0 + h < H ? scale[h0 + h] : 0.f;
    mx[h] = -INFINITY;
    sm[h] = 0.f;
  }
#pragma unroll 8
  for (int j = lane; j < Li; j += 32) {
    const float d = drow[j];
#pragma unroll
    for (int h = 0; h < HB; ++h) mx[h] = fmaxf(mx[h], logit(d, t, s[h]));
  }
#pragma unroll
  for (int h = 0; h < HB; ++h) mx[h] = warp_max(mx[h]);
#pragma unroll 8
  for (int j = lane; j < Li; j += 32) {
    const float d = drow[j];
#pragma unroll
    for (int h = 0; h < HB; ++h) sm[h] += expf(logit(d, t, s[h]) - mx[h]);
  }
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    sm[h] = warp_sum(sm[h]);
    if (lane == 0 && h0 + h < H) {
      M[(size_t)(h0 + h) * Lo + i] = mx[h];
      L[(size_t)(h0 + h) * Lo + i] = sm[h];
    }
  }
}

// --------------------------------------------------------------- dscale

// A block owns the heads [h0, h0 + HB) below H, TLO = NWARPS*RPT rows i and
// TN = 32*CPL columns n; warp w owns rows [w*RPT, w*RPT + RPT), lane c owns
// columns [c*CPL, c*CPL + CPL), as in the forward kernel.
template <int HB, int NWARPS, int RPT, int CPL, int TLI>
__global__ void __launch_bounds__(NWARPS * 32)
posatt_bwd_dscale_kernel(const float* __restrict__ dist,   // (Lo, Li)
                         const float* __restrict__ thr,    // (Lo)
                         const float* __restrict__ scale,  // (H)
                         const float* __restrict__ M,      // (H, Lo)
                         const float* __restrict__ L,      // (H, Lo)
                         const float* __restrict__ g,      // (B, Lo, H*D)
                         const float* __restrict__ u,      // (B, Li, D)
                         float* __restrict__ partial,      // (blocks, H)
                         int H, int Lo, int Li, int D, int N) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TLO = NWARPS * RPT;
  constexpr int TN = 32 * CPL;
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert(RPT == 1 || RPT == 4, "rows per thread");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  __shared__ __align__(16) float s_q[HB][TLI][TLO];  // P * (-d - v)
  __shared__ __align__(16) float s_u[TLI][TN];       // values
  __shared__ float s_m[HB][TLO];                      // row max
  __shared__ float s_l[HB][TLO];                      // row normaliser
  __shared__ float s_v[HB][TLO];                      // sum_j P * (-d)
  __shared__ float s_scale[HB];
  __shared__ float s_red[HB][NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * TLO;
  const int col0 = blockIdx.x * TN;
  const int h0 = blockIdx.z * HB;

  if (tid < HB) s_scale[tid] = h0 + tid < H ? scale[h0 + tid] : 0.f;
  __syncthreads();

  // ---- prologue: v_h[i] = sum_j P_h[i,j] * (-d_ij), one warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    const int i = row0 + r;
    if (i >= Lo) {  // never read back: keep the weights finite
      if (lane < HB) { s_m[lane][r] = 0.f; s_l[lane][r] = 1.f; s_v[lane][r] = 0.f; }
      continue;
    }
    const float t = thr[i];
    const float* drow = dist + (size_t)i * Li;
    float m[HB], l[HB], v[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) {  // a missing head: finite, never written
      const bool live = h0 + h < H;
      m[h] = live ? M[(size_t)(h0 + h) * Lo + i] : 0.f;
      l[h] = live ? L[(size_t)(h0 + h) * Lo + i] : 1.f;
      v[h] = 0.f;
    }
#pragma unroll 4
    for (int j = lane; j < Li; j += 32) {
      const float d = drow[j];
      if (kept(d, t)) {
#pragma unroll
        for (int h = 0; h < HB; ++h) v[h] += expf(-d * s_scale[h] - m[h]) / l[h] * -d;
      }
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      v[h] = warp_sum(v[h]);
      if (lane == 0) { s_m[h][r] = m[h]; s_l[h][r] = l[h]; s_v[h][r] = v[h]; }
    }
  }
  __syncthreads();

  // ---- Y = Q U over j steps, skipping steps without a kept entry
  const int rp = tid % TLO;  // the row this thread computes weights for
  const int ip = row0 + rp;
  const float tp = ip < Lo ? thr[ip] : 0.f;
  const float* dp = dist + (size_t)(ip < Lo ? ip : 0) * Li;
  const int cu = tid % TN;  // the value column this thread stages
  const int nu = col0 + cu;
  const bool col_ok = nu < N;
  const float* up = u;
  if (col_ok) {
    const int b = nu / D, k = nu - b * D;
    up = u + (size_t)b * Li * D + k;
  }

  float acc[HB][RPT][CPL];
#pragma unroll
  for (int h = 0; h < HB; ++h)
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[h][r][c] = 0.f;

  for (int j0 = 0; j0 < Li; j0 += TLI) {
    int any = 0;
#pragma unroll
    for (int q = 0; q < TLI * TLO / THREADS; ++q) {
      const int jj = tid / TLO + q * (THREADS / TLO);
      const int j = j0 + jj;
      const bool ok = ip < Lo && j < Li;
      const float d = ok ? dp[j] : 0.f;
      const bool k = ok && kept(d, tp);
      any |= k;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        s_q[h][jj][rp] = k ? expf(-d * s_scale[h] - s_m[h][rp]) / s_l[h][rp] * (-d - s_v[h][rp]) : 0.f;
    }
    if (__syncthreads_or(any)) {  // block-uniform: the values only when needed
#pragma unroll
      for (int q = 0; q < TLI * TN / THREADS; ++q) {
        const int jj = tid / TN + q * (THREADS / TN);
        const int j = j0 + jj;
        s_u[jj][cu] = (col_ok && j < Li) ? up[(size_t)j * D] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < TLI; ++jj) {
        float uv[CPL];
        lds<CPL>(&s_u[jj][lane * CPL], uv);
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          float qv[RPT];
          lds<RPT>(&s_q[h][jj][warp * RPT], qv);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[h][r][c] = fmaf(qv[r], uv[c], acc[h][r][c]);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: sum over the block's (i, n) of G * Y, per head
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
      if (n >= N) continue;
      const int b = n / D, k = n - b * D;
      const float* gp = g + ((size_t)b * Lo + i) * HD + (size_t)h0 * D + k;
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
    partial[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * H + h0 + tid] = s;
  }
}

// one warp (block) per head; each lane sums a fixed strided set of
// partials, then a fixed butterfly: the same bits on every run
__global__ void __launch_bounds__(32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ ds, int H,
                    int nparts) {
  const int lane = threadIdx.x;
  const int h = blockIdx.x;
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += partial[(size_t)p * H + h];
  s = warp_sum(s);
  if (lane == 0) ds[h] = s;
}

// ------------------------------------------------------------------- du

// A block owns TJ = NWARPS*RPT rows j of dU and TN = 32*CPL columns n; the
// contraction runs over (i, h) pairs of one group of HB heads at a time,
// KSTEP of them (TI = KSTEP/HB rows i) a step: 32 pairs for HB = 1, 2, 4, 8.
template <int HB, int NWARPS, int RPT, int CPL>
__global__ void __launch_bounds__(NWARPS * 32)
posatt_bwd_du_kernel(const float* __restrict__ dist,   // (Lo, Li)
                     const float* __restrict__ thr,    // (Lo)
                     const float* __restrict__ scale,  // (H)
                     const float* __restrict__ M,      // (H, Lo)
                     const float* __restrict__ L,      // (H, Lo)
                     const float* __restrict__ g,      // (B, Lo, H*D)
                     float* __restrict__ du,           // (B, Li, D)
                     int H, int Lo, int Li, int D, int N) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TJ = NWARPS * RPT;
  constexpr int TN = 32 * CPL;
  constexpr int TI = 32 / HB;
  constexpr int KSTEP = TI * HB;
  static_assert(THREADS % TN == 0, "tile shape");
  static_assert(RPT == 1 || RPT == 4, "rows per thread");
  __shared__ __align__(16) float s_p[KSTEP][TJ];  // pair kk = ii*HB + h
  __shared__ __align__(16) float s_g[KSTEP][TN];
  __shared__ float s_scale[HB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * TN;
  const int j0 = blockIdx.y * TJ;
  const int HD = H * D;

  const int cg = tid % TN;  // the column of G this thread stages
  const int ng = col0 + cg;
  const bool col_ok = ng < N;
  const float* gp = g;
  if (col_ok) {
    const int b = ng / D, k = ng - b * D;
    gp = g + (size_t)b * Lo * HD + k;
  }

  float acc[RPT][CPL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  for (int h0 = 0; h0 < H; h0 += HB) {
    __syncthreads();  // the last group's steps are done with s_scale
    if (tid < HB) s_scale[tid] = h0 + tid < H ? scale[h0 + tid] : 0.f;
    __syncthreads();
    for (int i0 = 0; i0 < Lo; i0 += TI) {
      int any = 0;
#pragma unroll
      for (int e = tid; e < TI * TJ; e += THREADS) {
        const int ii = e / TJ, jj = e - ii * TJ;
        const int i = i0 + ii, j = j0 + jj;
        const bool ok = i < Lo && j < Li;
        const float d = ok ? dist[(size_t)i * Li + j] : 0.f;
        const bool k = ok && kept(d, thr[ok ? i : 0]);
        any |= k;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const int hh = h0 + h;  // a missing head weighs 0
          s_p[ii * HB + h][jj] =
              k && hh < H ? expf(-d * s_scale[h] - M[(size_t)hh * Lo + i]) / L[(size_t)hh * Lo + i]
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
            s_g[kk][cg] = (col_ok && i < Lo && h < H) ? gp[(size_t)i * HD + h * D] : 0.f;
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

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = j0 + warp * RPT + r;
    if (j >= Li) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= N) continue;
      const int b = n / D, k = n - b * D;
      du[((size_t)b * Li + j) * D + k] = acc[r][c];
    }
  }
}

// --------------------------------------------------------------- launch

// heads per block (stats, dscale) or per group of du steps: at most 8, in
// ceil(H/8) groups as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

template <int HB>
int launch_stats(const float* dist, const float* thr, const float* scale,
                 float* M, float* L, int H, int Lo, int Li, cudaStream_t s) {
  const dim3 grid((Lo + STATS_WARPS - 1) / STATS_WARPS, (H + HB - 1) / HB);
  posatt_stats_kernel<HB><<<grid, STATS_WARPS * 32, 0, s>>>(dist, thr, scale, M, L, H, Lo, Li);
  return (int)cudaGetLastError();
}

template <int HB, int NWARPS, int RPT, int CPL, int TLI>
int dscale_tiles(const float* dist, const float* thr, const float* scale,
                 const float* M, const float* L, const float* g, const float* u,
                 float* partial, float* ds, int H, int Lo, int Li, int D, int N,
                 cudaStream_t s) {
  constexpr int TLO = NWARPS * RPT, TN = 32 * CPL;
  const dim3 grid((N + TN - 1) / TN, (Lo + TLO - 1) / TLO, (H + HB - 1) / HB);
  posatt_bwd_dscale_kernel<HB, NWARPS, RPT, CPL, TLI><<<grid, NWARPS * 32, 0, s>>>(
      dist, thr, scale, M, L, g, u, partial, H, Lo, Li, D, N);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<H, 32, 0, s>>>(partial, ds, H, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// the same two tile shapes as the forward kernel; the partial buffer must
// hold H * ceil(N/32) * ceil(Lo/8) floats, the block count of the smaller
template <int HB>
int launch_dscale(const float* dist, const float* thr, const float* scale,
                  const float* M, const float* L, const float* g, const float* u,
                  float* partial, float* ds, int H, int B, int Lo, int Li, int D,
                  cudaStream_t s) {
  const int N = B * D;
  if (N <= 32)
    return dscale_tiles<HB, 8, 1, 1, (HB >= 8 ? 64 : 128)>(
        dist, thr, scale, M, L, g, u, partial, ds, H, Lo, Li, D, N, s);
  return dscale_tiles<HB, 4, 4, 4, 32>(dist, thr, scale, M, L, g, u, partial, ds, H, Lo, Li, D,
                                       N, s);
}

template <int HB, int NWARPS, int RPT, int CPL>
int du_tiles(const float* dist, const float* thr, const float* scale,
             const float* M, const float* L, const float* g, float* du,
             int H, int Lo, int Li, int D, int N, cudaStream_t s) {
  constexpr int TJ = NWARPS * RPT, TN = 32 * CPL;
  const dim3 grid((N + TN - 1) / TN, (Li + TJ - 1) / TJ);
  posatt_bwd_du_kernel<HB, NWARPS, RPT, CPL><<<grid, NWARPS * 32, 0, s>>>(
      dist, thr, scale, M, L, g, du, H, Lo, Li, D, N);
  return (int)cudaGetLastError();
}

template <int HB>
int launch_du(const float* dist, const float* thr, const float* scale,
              const float* M, const float* L, const float* g, float* du,
              int H, int B, int Lo, int Li, int D, cudaStream_t s) {
  const int N = B * D;
  if (N <= 32)  // few columns: 8-row blocks of one column each per lane
    return du_tiles<HB, 8, 1, 1>(dist, thr, scale, M, L, g, du, H, Lo, Li, D, N, s);
  // 16 x 64 tiles: G is staged per head, so a block reuses each staged G
  // value H times less than the forward reuses a value; narrower tiles
  // give twice the blocks to hide its loads
  return du_tiles<HB, 4, 4, 2>(dist, thr, scale, M, L, g, du, H, Lo, Li, D, N, s);
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

}  // namespace

extern "C" int posatt_stats(const float* dist, const float* thr, const float* scale,
                            float* M, float* L, int H, int Lo, int Li, void* stream) {
  if (H < 1 || Lo < 1 || Li < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_HEAD_GROUP(launch_stats, dist, thr, scale, M, L, H, Lo, Li, s)
}

extern "C" int posatt_bwd_dscale(const float* dist, const float* thr, const float* scale,
                                 const float* M, const float* L, const float* g,
                                 const float* u, float* partial, float* ds, int H,
                                 int B, int Lo, int Li, int D, void* stream) {
  if (H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_HEAD_GROUP(launch_dscale, dist, thr, scale, M, L, g, u, partial, ds, H, B, Lo, Li, D, s)
}

extern "C" int posatt_bwd_du(const float* dist, const float* thr, const float* scale,
                             const float* M, const float* L, const float* g, float* du,
                             int H, int B, int Lo, int Li, int D, void* stream) {
  if (H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BY_HEAD_GROUP(launch_du, dist, thr, scale, M, L, g, du, H, B, Lo, Li, D, s)
}
