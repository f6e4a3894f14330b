// Fixed-mesh position attention, forward pass, hand-written for Hopper
// (sm_90a), float32 throughout: one kernel body under three schedules.
//
// Replaces the three TPU forward kernels of position_induced_transformer_tpu/
// kernels/posatt_pallas.py. They compute one function and differ only in
// what a grid cell owns, and so in how often the distance matrix is read:
// - posatt_fixed_fwd    <- _make_posatt_kernel_v3 (_posatt_fixed_raw_v3,
//   version 3): a block owns a tile of rows and a tile of the batch-folded
//   value columns, for all H heads (a group of them above 8 heads);
// - posatt_fixed_fwd_v2 <- _posatt_kernel_v2 (_posatt_fixed_raw_v2,
//   version 2): a block owns one head, a tile of rows and a tile of the
//   batch-folded value columns;
// - posatt_fixed_fwd_v1 <- _posatt_kernel (_posatt_fixed_raw, version 1):
//   a block owns one head, one sample and a tile of rows, with that
//   sample's D value columns.
// Each computes, for every output row i, head h and column n = b*D + k of
// the batch-folded values:
//
//   logit[h,i,j] = -scale[h] * dist[i,j]  if dist[i,j] <= thr[i] and finite
//                = -1e38                  otherwise (finite: no inf - inf)
//   out[b, i, h*D + k] = sum_j softmax_j(logit[h,i,:]) * u[b, j, k]
//
// and writes the head-concat layout (B, L_out, H*D) directly.
//
// What bounds it on this card: the function must read the (L_out, L_in)
// distance matrix once and write the output once; its operations are
// 2*H*B*D f32 per KEPT entry, since a masked weight is exactly 0. A global
// row keeps all L_in entries: with B*D = 512 (the Burgers processor) that
// is far above the H100's f32 ridge (67 TFLOP/s / 3.35 TB/s = 20 per byte),
// so the f32 CUDA-core rate bounds it. A masked row keeps a few entries
// (Burgers: 21 of 1024 in the encoder, 6 or 7 of 256 in the decoder), so
// reading the distances and writing the output bound it. The bound is the
// same under every schedule; what a schedule adds is its own streaming of
// the distance matrix: each block reads its rows' distances in both passes
// below, and a row tile has ceil(B*D/TN) blocks under v3, H*ceil(B*D/TN)
// under v2 and H*B under v1 (one column tile per sample while D <= 256;
// H*B*ceil(D/256) above that). Blocks that share a row tile are neighbours
// in launch order (blockIdx.x, the column tile or sample, varies fastest),
// so most of those reads hit the 50 MB L2; the head (blockIdx.z, slowest)
// is what sends the matrix through device memory again.
//
// What the design does about it:
// - Two passes over each block's rows. The first computes every row's
//   final softmax max and normaliser per head (one warp per row, one
//   reduction per row), so the second writes final weights and carries no
//   running max or rescale: its L_in loop is a plain accumulation. (The
//   TPU's online rescale across L_in grid steps exists because a TPU grid
//   runs in order; it is not carried over.)
// - Under v3 each distance element is read once per block for all H heads;
//   the H weight tiles P it yields are staged in shared memory and reused
//   by every value column of the block, so the exp work is amortised over
//   the columns.
// - The contraction is register-tiled: for wide tiles each thread holds 4
//   rows x CPL columns per head, reads 4 rows of P as one broadcast float4
//   and its values as float4s, so it issues 4*CPL FMAs per head for every
//   1 + CPL/4 shared-memory loads (the f32 rate, not shared memory, is the
//   limit). For few columns a block holds fewer rows and longer L_in
//   steps, so that there are more blocks and fewer barriers per element.
// - A v3 block owns a group of HB <= 8 heads: HB = H up to 8 heads (the
//   code of one group, GROUPED false), else ceil(H/8) groups as even as can
//   be (6 + 6 at H = 12), one per blockIdx.z, a short last group masking
//   its missing heads. Any head count is taken.
// - A v1 or v2 block owns one head, so its accumulator holds one head's
//   outputs and its column tile can be wider than v3's: the narrowest of
//   32, 64, 128 or 256 columns that holds its columns (v1: the sample's D;
//   v2: B*D). The price of owning one head: each staged value feeds one head's
//   products, so at H = 2 a v1 or v2 block issues twice v3's shared-memory
//   loads per FMA. Measured on the H100, that (and not the extra distance
//   streaming, which L2 serves) makes them 1.4-1.7x v3 where the
//   contraction bounds the time; for D <= 32 a v1 block also computes 32
//   columns for D live ones (PERF.md has the times).
// - Ragged edges are masked by index inside the kernel: no padded copy of
//   the distance matrix is made.
// Tensor cores are not used: TF32 would not hold parity with the f32
// oracle. The contraction is dense: masked entries are multiplied by their
// zero weights, so a masked row does L_in / kept times the operations it
// needs. Skipping them (a compacted kept list per row tile), double-buffered
// loads and splitting L_in across blocks are work for later.
//
// The functions launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG = -1e38f;

// what a block owns: the TPU kernel version it schedules as
enum Schedule { HEAD_SAMPLE = 1, HEAD = 2, ALL_HEADS = 3 };

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float logit(float d, float thr, float s) {
  return ((d <= thr) && (d < INFINITY)) ? -s * d : NEG;
}

// N consecutive floats from shared memory; 2, 4 or 8 of them as vector loads
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = p[i];
}
template <>
__device__ __forceinline__ void lds<2>(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}
template <>
__device__ __forceinline__ void lds<4>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void lds<8>(const float* p, float (&v)[8]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  const float4 r = *reinterpret_cast<const float4*>(p + 4);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  v[4] = r.x; v[5] = r.y; v[6] = r.z; v[7] = r.w;
}

// A block owns the heads [h0, h0 + HB) below H, TLO = NWARPS*RPT rows and
// the value columns [col0, col_end) of the batch-folded axis, at most
// TN = 32*CPL; warp w owns rows [w*RPT, w*RPT + RPT), lane c owns columns
// [c*CPL, c*CPL + CPL) from col0.
template <int SCHED, int HB, bool GROUPED, int NWARPS, int RPT, int CPL, int TLI>
__global__ void __launch_bounds__(NWARPS * 32)
posatt_fixed_fwd_kernel(const float* __restrict__ dist,   // (Lo, Li)
                        const float* __restrict__ thr,    // (Lo)
                        const float* __restrict__ scale,  // (H)
                        const float* __restrict__ u,      // (B, Li, D)
                        float* __restrict__ out,          // (B, Lo, H*D)
                        int H, int Lo, int Li, int D, int N, int HD, int ctiles) {
  constexpr int THREADS = NWARPS * 32;
  constexpr int TLO = NWARPS * RPT;
  constexpr int TN = 32 * CPL;
  static_assert(THREADS % TLO == 0 && THREADS % TN == 0, "tile shape");
  static_assert(RPT == 1 || RPT == 4, "rows per thread");
  static_assert((TLI * TN) % THREADS == 0 && (TLI * TLO) % THREADS == 0, "steps");
  static_assert(SCHED == ALL_HEADS || HB == 1, "v1 and v2 blocks own one head");
  __shared__ __align__(16) float s_p[HB][TLI][TLO];  // final weights
  __shared__ __align__(16) float s_u[TLI][TN];       // values
  __shared__ float s_m[HB][TLO];                      // row max
  __shared__ float s_il[HB][TLO];                     // 1 / row normaliser
  __shared__ float s_scale[HB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * TLO;
  // v1, v2: one head a block (HB = 1); v3: one group of heads
  const int h0 = (SCHED != ALL_HEADS || GROUPED) ? blockIdx.z * HB : 0;
  int col0, col_end;
  if (SCHED == HEAD_SAMPLE) {  // sample b, column tile c of its D columns
    const int b = blockIdx.x / ctiles;
    const int c0 = (blockIdx.x - b * ctiles) * TN;
    col0 = b * D + c0;
    col_end = b * D + min(D, c0 + TN);
  } else {
    col0 = blockIdx.x * TN;
    col_end = N;
  }

  if (tid < HB)  // a missing head: finite
    s_scale[tid] = (!GROUPED || h0 + tid < H) ? scale[h0 + tid] : 0.f;
  __syncthreads();

  // ---- pass 1: each row's softmax max and normaliser, one warp per row
  for (int r = warp; r < TLO; r += NWARPS) {
    const int i = row0 + r;
    if (i >= Lo) {  // never written; keep the weights finite
      if (lane < HB) { s_m[lane][r] = 0.f; s_il[lane][r] = 0.f; }
      continue;
    }
    const float t = thr[i];
    const float* drow = dist + (size_t)i * Li;
    float mx[HB], sm[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) { mx[h] = -INFINITY; sm[h] = 0.f; }
#pragma unroll 8
    for (int j = lane; j < Li; j += 32) {
      const float d = drow[j];
#pragma unroll
      for (int h = 0; h < HB; ++h) mx[h] = fmaxf(mx[h], logit(d, t, s_scale[h]));
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) mx[h] = warp_max(mx[h]);
#pragma unroll 8
    for (int j = lane; j < Li; j += 32) {
      const float d = drow[j];
#pragma unroll
      for (int h = 0; h < HB; ++h) sm[h] += expf(logit(d, t, s_scale[h]) - mx[h]);
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      sm[h] = warp_sum(sm[h]);
      if (lane == 0) { s_m[h][r] = mx[h]; s_il[h][r] = 1.f / sm[h]; }
    }
  }
  __syncthreads();

  // ---- pass 2: stage final weights and values per L_in step, contract
  const int rp = tid % TLO;  // the row this thread computes weights for
  const int ip = row0 + rp;
  const float tp = ip < Lo ? thr[ip] : 0.f;
  const float* dp = dist + (size_t)(ip < Lo ? ip : 0) * Li;
  const int cu = tid % TN;  // the value column this thread stages
  const int nu = col0 + cu;
  const bool col_ok = nu < col_end;
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
    // constant trip counts, fully unrolled: every load of a step is in
    // flight at once
#pragma unroll
    for (int q = 0; q < TLI * TN / THREADS; ++q) {
      const int jj = tid / TN + q * (THREADS / TN);
      const int j = j0 + jj;
      s_u[jj][cu] = (col_ok && j < Li) ? up[(size_t)j * D] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < TLI * TLO / THREADS; ++q) {
      const int jj = tid / TLO + q * (THREADS / TLO);
      const int j = j0 + jj;
      const bool ok = ip < Lo && j < Li;
      const float d = ok ? dp[j] : 0.f;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        s_p[h][jj][rp] = ok ? expf(logit(d, tp, s_scale[h]) - s_m[h][rp]) * s_il[h][rp] : 0.f;
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

  // ---- write the head-concat layout
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = row0 + warp * RPT + r;
    if (i >= Lo) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int n = col0 + lane * CPL + c;
      if (n >= col_end) continue;
      const int b = n / D, k = n - b * D;
      float* dst = out + ((size_t)b * Lo + i) * HD + k;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        if (!GROUPED || h0 + h < H) dst[(h0 + h) * D] = acc[h][r][c];
    }
  }
}

template <int SCHED, int HB, bool GROUPED, int NWARPS, int RPT, int CPL, int TLI>
void launch_tiles(const float* dist, const float* thr, const float* scale,
                  const float* u, float* out, int H, int B, int Lo, int Li, int D,
                  cudaStream_t stream) {
  constexpr int TLO = NWARPS * RPT, TN = 32 * CPL;
  const int N = B * D;
  const int ctiles = (D + TN - 1) / TN;  // column tiles of one sample (v1)
  const dim3 grid(SCHED == HEAD_SAMPLE ? B * ctiles : (N + TN - 1) / TN,
                  (Lo + TLO - 1) / TLO, (H + HB - 1) / HB);
  posatt_fixed_fwd_kernel<SCHED, HB, GROUPED, NWARPS, RPT, CPL, TLI><<<grid, NWARPS * 32, 0, stream>>>(
      dist, thr, scale, u, out, H, Lo, Li, D, N, H * D, ctiles);
}

// v3: a group of HB heads a block
template <int HB, bool GROUPED>
void launch_all_heads(const float* dist, const float* thr, const float* scale,
                      const float* u, float* out, int H, int B, int Lo, int Li, int D,
                      cudaStream_t stream) {
  if (B * D <= 32)  // few columns: 8-row blocks, long L_in steps
    launch_tiles<ALL_HEADS, HB, GROUPED, 8, 1, 1, (HB >= 8 ? 64 : 128)>(
        dist, thr, scale, u, out, H, B, Lo, Li, D, stream);
  else  // 16 x 128 blocks, 4 x 4 outputs per thread and head
    launch_tiles<ALL_HEADS, HB, GROUPED, 4, 4, 4, 32>(dist, thr, scale, u, out, H, B, Lo, Li, D,
                                                      stream);
}

// heads per v3 block above 8 heads: ceil(H/8) groups as even as can be,
// 5 to 8 heads each
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

// v1 and v2: one head a block, the narrowest column tile that holds
// `cols` columns (at most 256)
template <int SCHED>
void launch_per_head(const float* dist, const float* thr, const float* scale,
                     const float* u, float* out, int H, int B, int Lo, int Li, int D,
                     int cols, cudaStream_t stream) {
  if (cols <= 32)  // 8 x 32
    launch_tiles<SCHED, 1, false, 8, 1, 1, 128>(dist, thr, scale, u, out, H, B, Lo, Li, D, stream);
  else if (cols <= 64)  // 16 x 64
    launch_tiles<SCHED, 1, false, 4, 4, 2, 32>(dist, thr, scale, u, out, H, B, Lo, Li, D, stream);
  else if (cols <= 128)  // 16 x 128
    launch_tiles<SCHED, 1, false, 4, 4, 4, 32>(dist, thr, scale, u, out, H, B, Lo, Li, D, stream);
  else  // 32 x 256
    launch_tiles<SCHED, 1, false, 8, 4, 8, 32>(dist, thr, scale, u, out, H, B, Lo, Li, D, stream);
}

bool bad_shape(int H, int B, int Lo, int Li, int D) {
  return H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1;
}

}  // namespace

extern "C" int posatt_fixed_fwd(const float* dist, const float* thr,
                                const float* scale, const float* u, float* out,
                                int H, int B, int Lo, int Li, int D,
                                void* stream) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: launch_all_heads<1, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 2: launch_all_heads<2, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 3: launch_all_heads<3, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 4: launch_all_heads<4, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 5: launch_all_heads<5, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 6: launch_all_heads<6, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 7: launch_all_heads<7, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    case 8: launch_all_heads<8, false>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
    default:
      switch (head_group(H)) {
        case 5: launch_all_heads<5, true>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
        case 6: launch_all_heads<6, true>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
        case 7: launch_all_heads<7, true>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
        default: launch_all_heads<8, true>(dist, thr, scale, u, out, H, B, Lo, Li, D, s); break;
      }
  }
  return (int)cudaGetLastError();
}

extern "C" int posatt_fixed_fwd_v2(const float* dist, const float* thr,
                                   const float* scale, const float* u, float* out,
                                   int H, int B, int Lo, int Li, int D,
                                   void* stream) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  launch_per_head<HEAD>(dist, thr, scale, u, out, H, B, Lo, Li, D, B * D,
                        static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int posatt_fixed_fwd_v1(const float* dist, const float* thr,
                                   const float* scale, const float* u, float* out,
                                   int H, int B, int Lo, int Li, int D,
                                   void* stream) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  launch_per_head<HEAD_SAMPLE>(dist, thr, scale, u, out, H, B, Lo, Li, D, D,
                               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
