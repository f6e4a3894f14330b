// Fixed-mesh TF-semantics position attention, backward pass (#13),
// hand-written for Hopper (sm_90a), float32 throughout. Two C entry points
// for the gradients of posatt_tf_fixed_fwd.cu's output (no Pallas kernel to
// replace: the JAX package takes them by autodiff of XLA's
// MultiHeadPosAtt, position_induced_transformer_tpu/models/pit_tf.py:129-160):
//
//   posatt_tf_fixed_bwd_dv      dvalues (B, Li, H*V):
//                               dv[b, j, h*V + c] = sum_i w[h,i,j] g[b, i, h*V + c]
//   posatt_tf_fixed_bwd_dscale  dscale (H), over the whole batch:
//                               T[h,i,j] = sum_b sum_c g[b,i,h*V+c] values[b,j,h*V+c]
//                               r[h,i]   = sum_b sum_c g[b,i,h*V+c] out[b,i,h*V+c]
//                               ds[h]    = -sum_ij keep * w (T - r) d
//
// (w, keep and the forward's stats m and l as posatt_tf_fixed.cuh defines
// them). The mask and the thresholds get no gradient, as jnp.where gives
// none; r reads the forward's output.
//
// What bounds them on this card: 2*B*V operations per (head, row, column)
// entry each, as the forward, so the f32 CUDA-core rate.
//
// Design: the forward's register-tiled SGEMM (posatt_tf_fixed.cuh).
// - dv_kernel: a block owns 128 input columns j, one head and a column tile
//   of the cotangent; a step computes 8 rows' weights of its 128 columns
//   (coalesced along j) and stages the 8 cotangent rows beside them; a
//   launch of few blocks also splits Lo (posatt_tf_fixed.cuh).
// - dscale: r_kernel (a warp a row and head, fixed lane order), then
//   dscale_kernel: a block owns a 128 x 128 (i, j) tile of one head and
//   contracts g and values over every (sample, value column) pair into T in
//   registers; its epilogue weighs each entry and sums the tile into one
//   partial in a fixed order; reduce_kernel sums each head's partials in a
//   fixed order. No atomics: the same bits on every run.
//
// Each entry point launches on the caller's stream, allocates nothing (the
// caller passes the scratch), and returns cudaGetLastError() after the
// launches.

#include "posatt_tf_fixed.cuh"

namespace {

using namespace tffixed;

__global__ void __launch_bounds__(THREADS, 2) dv_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ g, const float* __restrict__ stats, float* __restrict__ dv,
    int B, int Lo, int Li, int H, int V, int mode, int BT, int CW, int nct, int kchunk) {
  __shared__ __align__(16) float As[BK][BM];  // weights: 8 rows i of 128 columns j
  __shared__ __align__(16) float Bs[BK][BN];  // cotangent rows
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * BM, h = blockIdx.z % H, split = blockIdx.z / H;
  const Cols cols = cols_of(blockIdx.y, BT, CW, nct);
  const int HV = H * V;
  const float s = scale[h];
  const int k_begin = split * kchunk, k_end = min(Lo, k_begin + kchunk);
  dv += (size_t)split * B * Li * HV;  // this split's partial sums
  const float* sm = stats + (size_t)(2 * h) * Lo;
  const float* sl = stats + (size_t)(2 * h + 1) * Lo;
  const int n = tid % BN, krow = tid / BN;
  int b, c;
  const bool nok = cols.at(n, B, V, &b, &c);
  const float* gcol = nok ? g + (size_t)b * Lo * HV + (size_t)h * V + c : g;
  const int j = j0 + n;  // this thread's weight column
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int kk = krow + 2 * r, i = k0 + kk;
      float w = 0.f;
      if (i < k_end && j < Li) {
        bool k;
        w = weight(dist[(size_t)i * Li + j], s, keep_threshold(thr, i, s, mode), sm[i], sl[i],
                   mode, &k);
      }
      As[kk][n] = w;
      Bs[kk][n] = (nok && i < k_end) ? gcol[(size_t)i * HV] : 0.f;
    }
    __syncthreads();
    step_product<BM, BN>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int bq, cq;
    if (!cols.at(lane_pos(tx, q), B, V, &bq, &cq)) continue;
    float* o = dv + (size_t)bq * Li * HV + (size_t)h * V + cq;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int jj = j0 + lane_pos(ty, r);
      if (jj < Li) o[(size_t)jj * HV] = acc[r][q];
    }
  }
}

__global__ void __launch_bounds__(THREADS) r_kernel(
    const float* __restrict__ g, const float* __restrict__ out, float* __restrict__ rvec,
    int B, int Lo, int H, int V) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;  // h * Lo + i
  if (row >= H * Lo) return;
  const int h = row / Lo, i = row % Lo, HV = H * V;
  float r = 0.f;
  for (int n = lane; n < B * V; n += 32) {
    const size_t at = ((size_t)(n / V) * Lo + i) * HV + (size_t)h * V + n % V;
    r = fmaf(g[at], out[at], r);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  if (lane == 0) rvec[row] = r;
}

__global__ void __launch_bounds__(THREADS, 2) dscale_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ values, const float* __restrict__ g, const float* __restrict__ stats,
    const float* __restrict__ rvec, float* __restrict__ partial, int B, int Lo, int Li, int H,
    int V, int mode) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // g: 8 (sample, column) pairs of 128 rows
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // values: the same pairs of 128 columns
  __shared__ float rt[BM], rm[BM], rl[BM], rr[BM];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN, h = blockIdx.z;
  const int HV = H * V, K = B * V;
  const float s = scale[h];
  if (tid < BM) {
    const int i = i0 + tid;
    const bool ok = i < Lo;
    rt[tid] = ok ? keep_threshold(thr, i, s, mode) : 0.f;
    rm[tid] = ok ? stats[(size_t)(2 * h) * Lo + i] : 0.f;
    rl[tid] = ok ? stats[(size_t)(2 * h + 1) * Lo + i] : 1.f;
    rr[tid] = ok ? rvec[(size_t)h * Lo + i] : 0.f;
  }
  const int lrow = tid / BK, kk = tid % BK;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int n = k0 + kk;
    const bool nok = n < K;
    const int b = nok ? n / V : 0, c = nok ? n % V : 0;
    const float* gb = g + (size_t)b * Lo * HV + (size_t)h * V + c;
    const float* vb = values + (size_t)b * Li * HV + (size_t)h * V + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = lrow + 32 * r, i = i0 + row, j = j0 + row;
      As[kk][row] = (nok && i < Lo) ? gb[(size_t)i * HV] : 0.f;
      Bs[kk][row] = (nok && j < Li) ? vb[(size_t)j * HV] : 0.f;
    }
    __syncthreads();
    step_product<BM + PAD, BN + PAD>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  float part = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = lane_pos(ty, r), i = i0 + row;
    if (i >= Lo) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + lane_pos(tx, q);
      if (j >= Li) continue;
      const float d = dist[(size_t)i * Li + j];
      bool k;
      const float w = weight(d, s, rt[row], rm[row], rl[row], mode, &k);
      if (k) part -= w * (acc[r][q] - rr[row]) * d;
    }
  }
  red[tid] = part;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  if (tid == 0) {
    const size_t blocks = (size_t)gridDim.x * gridDim.y;
    partial[(size_t)h * blocks + (size_t)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(const float* __restrict__ partial,
                                                         float* __restrict__ ds, int n) {
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, h = blockIdx.x;
  float v = 0.f;
  for (int k = tid; k < n; k += THREADS) v += partial[(size_t)h * n + k];
  red[tid] = v;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  if (tid == 0) ds[h] = red[0];
}

}  // namespace

// part: scratch of (splits, B, Li, H*V) floats where splits > 1, else null
extern "C" int posatt_tf_fixed_bwd_dv(const float* dist, const float* thr, const float* scale,
                                      const float* g, const float* stats, float* dv, float* part,
                                      int B, int Lo, int Li, int H, int V, int mode, int splits,
                                      int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ColPlan p = col_plan(B, V);
  dim3 grid((Li + BM - 1) / BM, p.tiles, H * splits);
  dv_kernel<<<grid, THREADS, 0, st>>>(dist, thr, scale, g, stats, splits > 1 ? part : dv, B, Lo,
                                      Li, H, V, mode, p.BT, p.CW, p.nct,
                                      splits > 1 ? kchunk : Lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, dv, (size_t)B * Li * H * V, splits, st);
}

// scratch: rvec (H * Lo) and partial (H * ceil(Lo / 128) * ceil(Li / 128))
extern "C" int posatt_tf_fixed_bwd_dscale(const float* dist, const float* thr,
                                          const float* scale, const float* values,
                                          const float* out, const float* g, const float* stats,
                                          float* rvec, float* partial, float* ds, int B, int Lo,
                                          int Li, int H, int V, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = THREADS / 32;
  r_kernel<<<(H * Lo + rows_per_block - 1) / rows_per_block, THREADS, 0, st>>>(g, out, rvec, B,
                                                                              Lo, H, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((Lo + BM - 1) / BM, (Li + BN - 1) / BN, H);
  dscale_kernel<<<grid, THREADS, 0, st>>>(dist, thr, scale, values, g, stats, rvec, partial, B,
                                          Lo, Li, H, V, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<H, THREADS, 0, st>>>(partial, ds, (int)(grid.x * grid.y));
  return cudaGetLastError();
}
