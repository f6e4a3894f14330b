// Fixed-mesh TF-semantics position attention, forward pass (#13),
// hand-written for Hopper (sm_90a), float32 throughout. One C entry point:
//
//   posatt_tf_fixed_fwd  replaces no Pallas kernel: the JAX package runs
//                        this op on XLA (position_induced_transformer_tpu/
//                        models/pit_tf.py:129-160, MultiHeadPosAtt). It is
//                        every attention op of the fixed-mesh TF family
//                        (burgers_tf, sod_tf, darcy_tf, vorticity_tf,
//                        naca_tf).
//
// Inputs: dist (Lo, Li), shared by the whole batch; thr (Lo, 2), the
// quantiles at p and 1 - p of each row, or null (global); scale (H), of
// either sign; values (B, Li, H*V), head h's columns at h*V...(h+1)*V.
// Outputs: out (B, Lo, H*V) with
//
//   out[b, i, h*V + c] = sum_j w[h,i,j] values[b, j, h*V + c]
//
// (posatt_tf_fixed.cuh defines w), and stats (H, 2, Lo): m and l of each
// head and row, which the backward entry points read.
//
// What bounds it on this card: 2*B*V operations per (head, row, column)
// entry against the distances, values and output: at every op of the five
// configurations that is far above the f32 ridge of 20 operations per byte,
// so the f32 CUDA-core rate bounds it (naca_tf's decoder: 133 GFLOP, about
// 2 ms). Tensor cores are not used: TF32 would not hold parity with the f32
// plain version.
//
// Design, a simple one first:
// - stats_kernel: a warp a row scans the row twice per head, for m and then
//   for l, in a fixed lane order (the same bits on every run);
// - fwd_kernel: the product W_h (Lo x Li) times head h's values, taken as a
//   (Li, B*V) matrix, as a register-tiled SGEMM: a block owns 128 rows, one
//   head and a column tile of up to 8 samples by 128 / 8 value columns, so a
//   batch of 8 or fewer reads each distance once per block for all its
//   samples and never as a (B, Lo, Li) expansion (a launch of few blocks
//   also splits Li: posatt_tf_fixed.cuh). A step computes the
//   128 x 8 weights of its tile from the distances into shared memory,
//   stages 8 value rows beside them, and each of 256 threads adds 8 x 8
//   products from two float4 reads of each.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launches.

#include "posatt_tf_fixed.cuh"

namespace {

using namespace tffixed;

__global__ void __launch_bounds__(THREADS) stats_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    float* __restrict__ stats, int Lo, int Li, int H, int mode) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (i >= Lo) return;
  const float* row = dist + (size_t)i * Li;
  for (int h = 0; h < H; ++h) {
    const float s = scale[h];
    const float t = keep_threshold(thr, i, s, mode);
    float m = INFINITY;
    for (int j = lane; j < Li; j += 32) {
      const float d = row[j];
      const float sd = __fmul_rn(s, d);
      if (kept(d, sd, t, mode)) m = fminf(m, sd);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = (float)Li;
    if (!isinf(m)) {
      l = 0.f;
      for (int j = lane; j < Li; j += 32) {
        const float d = row[j];
        const float sd = __fmul_rn(s, d);
        if (kept(d, sd, t, mode)) l += expf(__fsub_rn(m, sd));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    }
    if (lane == 0) {
      stats[(size_t)(2 * h) * Lo + i] = m;
      stats[(size_t)(2 * h + 1) * Lo + i] = l;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) fwd_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ values, const float* __restrict__ stats, float* __restrict__ out,
    int B, int Lo, int Li, int H, int V, int mode, int BT, int CW, int nct, int kchunk) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // weights, depth first
  __shared__ __align__(16) float Bs[BK][BN];        // value rows
  __shared__ float rt[BM], rm[BM], rl[BM];          // the rows' t, m and l
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BM, h = blockIdx.z % H, split = blockIdx.z / H;
  const Cols cols = cols_of(blockIdx.y, BT, CW, nct);
  const int HV = H * V;
  const float s = scale[h];
  const int k_begin = split * kchunk, k_end = min(Li, k_begin + kchunk);
  out += (size_t)split * B * Lo * HV;  // this split's partial sums
  if (tid < BM) {
    const int i = i0 + tid;
    const bool ok = i < Lo;
    rt[tid] = ok ? keep_threshold(thr, i, s, mode) : 0.f;
    rm[tid] = ok ? stats[(size_t)(2 * h) * Lo + i] : 0.f;
    rl[tid] = ok ? stats[(size_t)(2 * h + 1) * Lo + i] : 1.f;
  }
  // this thread's value column, the same at every step
  const int n = tid % BN;
  int b, c;
  const bool nok = cols.at(n, B, V, &b, &c);
  const float* vcol = nok ? values + (size_t)b * Li * HV + (size_t)h * V + c : values;
  const int arow = tid / BK, acol = tid % BK, brow = tid / BN;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  }
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int j = k0 + acol;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = arow + 32 * r, i = i0 + row;
      float w = 0.f;
      if (i < Lo && j < k_end) {
        bool k;
        w = weight(dist[(size_t)i * Li + j], s, rt[row], rm[row], rl[row], mode, &k);
      }
      As[acol][row] = w;
    }
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int kk = brow + 2 * r, jj = k0 + kk;
      Bs[kk][n] = (nok && jj < k_end) ? vcol[(size_t)jj * HV] : 0.f;
    }
    __syncthreads();
    step_product<BM + PAD, BN>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int bq, cq;
    if (!cols.at(lane_pos(tx, q), B, V, &bq, &cq)) continue;
    float* o = out + (size_t)bq * Lo * HV + (size_t)h * V + cq;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + lane_pos(ty, r);
      if (i < Lo) o[(size_t)i * HV] = acc[r][q];
    }
  }
}

}  // namespace

// part: scratch of (splits, B, Lo, H*V) floats where splits > 1, else null
extern "C" int posatt_tf_fixed_fwd(const float* dist, const float* thr, const float* scale,
                                   const float* values, float* out, float* stats, float* part,
                                   int B, int Lo, int Li, int H, int V, int mode, int splits,
                                   int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = THREADS / 32;
  stats_kernel<<<(Lo + rows_per_block - 1) / rows_per_block, THREADS, 0, st>>>(
      dist, thr, scale, stats, Lo, Li, H, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ColPlan p = col_plan(B, V);
  dim3 grid((Lo + BM - 1) / BM, p.tiles, H * splits);
  fwd_kernel<<<grid, THREADS, 0, st>>>(dist, thr, scale, values, stats, splits > 1 ? part : out,
                                       B, Lo, Li, H, V, mode, p.BT, p.CW, p.nct,
                                       splits > 1 ? kchunk : Li);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, out, (size_t)B * Lo * H * V, splits, st);
}
