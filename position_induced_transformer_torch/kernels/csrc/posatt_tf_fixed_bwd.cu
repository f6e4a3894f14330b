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
// (w, keep, the forward's stats m and l and the plan's lists as
// posatt_tf_fixed.cuh defines them). The mask and the thresholds get no
// gradient, as jnp.where gives none; r reads the forward's output.
//
// What bounds them on this card: 2*B*V operations per kept (head, row,
// column) entry each, as the forward, so the f32 CUDA-core rate.
//
// Design: the forward's pipelined product (a ring of three cp.async stages,
// one barrier a step, 8 x 8 products a thread).
// - dv_kernel: a block owns 128 input columns j, one head and a column tile
//   of the cotangent, and walks its column tile's list of 16-row steps; a
//   step stages 16 rows of distances (coalesced along j), their m, l and
//   threshold, and 16 cotangent rows, and turns the distances into weights
//   in place, once per block; a launch of few blocks splits the list across
//   blocks, summed in order by sum_splits.
// - dscale: r_kernel (a warp a row and head, fixed lane order), then
//   dscale_kernel: a block owns a 128 x 128 (i, j) tile of one head, returns
//   at once where the plan's tile flag says the tile keeps nothing, and
//   contracts its share of the (sample, value column) pairs into T in
//   registers; its epilogue weighs each kept entry and sums the tile into
//   one partial in a fixed order; a launch of few tiles splits the
//   contraction (r's term in the first split only); reduce_kernel sums
//   each head's partials in a fixed order. No atomics: the same bits on
//   every run.
//
// Each entry point launches on the caller's stream, allocates nothing (the
// caller passes the scratch), and returns cudaGetLastError() after the
// launches.

#include "posatt_tf_fixed.cuh"

namespace {

using namespace tffixed;

template <int BMT>
constexpr int dv_smem() {  // distances (then weights), cotangents, the rows' m, l, t
  return (STAGES * SW * BMT + STAGES * SW * BN + STAGES * 3 * SW) * 4;
}

// A block of BMT = 128, 64 or 32 input columns j (16 * RT: RT a thread)
// walks its column tile's list (the plan's lists are cut to the same tiles).
template <int BMT>
__global__ void __launch_bounds__(THREADS, 2) dv_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ g, const float* __restrict__ stats,
    const int* __restrict__ list_idx, const int* __restrict__ list_cnt, float* __restrict__ dv,
    int B, int Lo, int Li, int H, int V, int mode, int BT, int CW, int nct, int nU, int chunk,
    int vecd, int vecv) {
  constexpr int RT = BMT / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ds = smem;                    // STAGES x SW x BMT: distances, then weights, in place
  float* Gs = Ds + STAGES * SW * BMT;  // STAGES x SW x BN: cotangent rows
  float* Rs = Gs + STAGES * SW * BN;   // STAGES x 3 x SW: the rows' m, l and threshold
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * BMT, h = blockIdx.z % H, split = blockIdx.z / H;
  const Cols cols = cols_of(blockIdx.y, BT, CW, nct);
  const int HV = H * V;
  const float s = scale[h];
  dv += (size_t)split * B * Li * HV;  // this split's partial sums

  const size_t tile = (size_t)h * gridDim.x + blockIdx.x;
  const int* lst = list_idx ? list_idx + tile * nU : nullptr;
  const int cnt = list_idx ? list_cnt[tile] : nU;
  int beg, end;
  split_range(lst, cnt, split, chunk, &beg, &end);
  const int n = end - beg;
  auto step = [&](int p) { return lst ? __ldg(lst + beg + p) : beg + p; };

  const ColStage cs = stage_cols(cols, g, B, Lo, H, V, h, vecv, tid);
  const int thr_col = (mode == 1 && s < 0.f) ? 1 : 0;
  auto load = [&](int u, int slot) {
    const int i0 = u * SW;
    float* D = Ds + slot * SW * BMT;
    if (vecd) {
#pragma unroll
      for (int q = 0; q < cdiv(SW * BMT / 4, THREADS); ++q) {
        const int e = tid + q * THREADS, k = e / (BMT / 4), c = 4 * (e % (BMT / 4));
        const int i = i0 + k, j = j0 + c;
        const bool ok = i < Lo && j < Li;
        if (SW * BMT / 4 >= THREADS || e < SW * BMT / 4)
          cp16(D + k * BMT + c, ok ? dist + (size_t)i * Li + j : dist, ok);
      }
    } else {  // row k a thread, every 16th column from one address: coalesced
      const int k = tid / 16, c = tid % 16, i = i0 + k;
      const float* src = dist + (size_t)(i < Lo ? i : 0) * Li + j0 + c;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const bool ok = i < Lo && j0 + c + 16 * q < Li;
        cp4(D + k * BMT + c + 16 * q, ok ? src + 16 * q : dist, ok);
      }
    }
    load_cols(Gs + slot * SW * BN, cs, i0, Lo, HV, vecv);
    if (tid < 3 * SW) {
      const int what = tid / SW, i = i0 + tid % SW;
      const bool ok = i < Lo && (what < 2 || thr != nullptr);
      const size_t at = ok ? i : 0;
      const float* src = what < 2 ? stats + (size_t)(2 * h + what) * Lo + at
                                  : (ok ? thr + 2 * at + thr_col : stats);
      cp4(Rs + slot * 3 * SW + tid, src, ok);
    }
  };
  // the weights of step u (in stage `slot`), in place: row k, the RT
  // columns row_pos<RT>(wc, .)
  const int wk = tid / 16, wc = tid % 16;
  auto weigh = [&](int u, int slot) {
    const float* R = Rs + slot * 3 * SW;
    const int i = u * SW + wk;
    const float m = R[wk], l = R[SW + wk], rlk = __frcp_rn(l);
    const float t = thr == nullptr ? INFINITY : (mode == 0 ? R[2 * SW + wk]
                                                           : __fmul_rn(s, R[2 * SW + wk]));
    float* D = Ds + slot * SW * BMT + wk * BMT;
    float d[RT];
    lds_rows<RT>(D, wc, d);
#pragma unroll
    for (int e = 0; e < RT; ++e) {
      const int j = j0 + row_pos<RT>(wc, e);
      d[e] = (i < Lo && j < Li) ? weight(d[e], s, t, m, l, rlk, mode) : 0.f;
    }
    sts_rows<RT>(D, wc, d);
  };

  float acc[RT][8];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
  }
  int t1 = n > 1 ? step(1) : 0, t2 = n > 2 ? step(2) : 0;
  if (n > 0) load(step(0), 0);
  cp_commit();
  if (n > 1) load(t1, 1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  if (n > 0) weigh(step(0), 0);
  for (int k = 0; k < n; ++k) {
    cp_wait<0>();
    __syncthreads();
    if (k + 2 < n) load(t2, (k + 2) % STAGES);
    cp_commit();
    const int t3 = k + 3 < n ? step(k + 3) : 0;
    if (k + 1 < n) weigh(t1, (k + 1) % STAGES);
    step_product<RT, BMT, BN>(Ds + (k % STAGES) * SW * BMT, Gs + (k % STAGES) * SW * BN, tx, ty,
                              acc);
    t1 = t2;
    t2 = t3;
  }
  store_tile<RT>(dv, acc, cols, j0, Li, B, H, V, h, tx, ty, vecv);
}

template <int BMT>
cudaError_t launch_dv(dim3 grid, cudaStream_t st, const float* dist, const float* thr,
                      const float* scale, const float* g, const float* stats,
                      const int* dv_idx, const int* dv_cnt, float* dv, int B, int Lo, int Li,
                      int H, int V, int mode, const ColPlan& p, int chunk, int vecd, int vecv) {
  cudaError_t err = cudaFuncSetAttribute(dv_kernel<BMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dv_smem<BMT>());
  if (err != cudaSuccess) return err;
  dv_kernel<BMT><<<grid, THREADS, dv_smem<BMT>(), st>>>(
      dist, thr, scale, g, stats, dv_idx, dv_cnt, dv, B, Lo, Li, H, V, mode, p.BT, p.CW,
      p.nct, cdiv(Lo, SW), chunk, vecd, vecv);
  return cudaGetLastError();
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

constexpr int AP = BM + 4;  // a staged operand row, padded (transposing copies)
constexpr int DS_SMEM = (2 * STAGES * SW * AP) * 4;

__global__ void __launch_bounds__(THREADS, 2) dscale_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ values, const float* __restrict__ g, const float* __restrict__ stats,
    const int* __restrict__ tiles, const float* __restrict__ rvec, float* __restrict__ partial,
    int B, int Lo, int Li, int H, int V, int mode, int splits, int kchunk) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // STAGES x SW x AP: g, 16 pairs of 128 rows
  float* Bs = As + STAGES * SW * AP;   // STAGES x SW x AP: values, the same pairs of 128 columns
  __shared__ float rt[BM], rm[BM], rl[BM], rrl[BM], rr[BM];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int I = blockIdx.x, J = blockIdx.y, h = blockIdx.z % H, split = blockIdx.z / H;
  const int nI = gridDim.x, nJ = gridDim.y;
  const int i0 = I * BM, j0 = J * BN;
  const size_t slot_out = ((size_t)(h * splits + split) * nJ + J) * nI + I;
  if (tiles != nullptr && !tiles[((size_t)h * nI + I) * nJ + J]) {
    if (tid == 0) partial[slot_out] = 0.f;  // keeps no entry: adds nothing
    return;
  }
  const int HV = H * V, K = B * V;
  const float s = scale[h];
  if (tid < BM) {
    const int i = i0 + tid;
    const bool ok = i < Lo;
    rt[tid] = ok ? keep_threshold(thr, i, s, mode) : 0.f;
    rm[tid] = ok ? stats[(size_t)(2 * h) * Lo + i] : INFINITY;
    rl[tid] = ok ? stats[(size_t)(2 * h + 1) * Lo + i] : 1.f;
    rrl[tid] = __frcp_rn(rl[tid]);
    rr[tid] = (ok && split == 0) ? rvec[(size_t)h * Lo + i] : 0.f;  // r's term once
  }
  const int kbeg = split * kchunk, kend = min(K, kbeg + kchunk);
  const int n = kend > kbeg ? cdiv(kend - kbeg, SW) : 0;
  const int kk = tid % SW, r0 = tid / SW;
  auto load = [&](int p, int slot) {
    const int c = kbeg + p * SW + kk;
    const bool cok = c < kend;
    const int b = cok ? c / V : 0, v = cok ? c % V : 0;
    const float* ga = g + (size_t)b * Lo * HV + (size_t)h * V + v;
    const float* va = values + (size_t)b * Li * HV + (size_t)h * V + v;
    float* A = As + slot * SW * AP + kk * AP;
    float* Bv = Bs + slot * SW * AP + kk * AP;
#pragma unroll
    for (int q = 0; q < BM * SW / THREADS; ++q) {
      const int row = r0 + q * (THREADS / SW), i = i0 + row, j = j0 + row;
      cp4(A + row, cok && i < Lo ? ga + (size_t)i * HV : g, cok && i < Lo);
      cp4(Bv + row, cok && j < Li ? va + (size_t)j * HV : values, cok && j < Li);
    }
  };
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
  }
  if (n > 0) load(0, 0);
  cp_commit();
  if (n > 1) load(1, 1);
  cp_commit();
  for (int k = 0; k < n; ++k) {
    cp_wait<1>();
    __syncthreads();
    if (k + 2 < n) load(k + 2, (k + 2) % STAGES);
    cp_commit();
    step_product<8, AP, AP>(As + (k % STAGES) * SW * AP, Bs + (k % STAGES) * SW * AP, tx, ty,
                            acc);
  }
  __syncthreads();  // the row info, where no step ran
  float part = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = lane_pos(ty, a), i = i0 + row;
    const float m = rm[row];
    if (i >= Lo || isinf(m)) continue;  // a row that keeps nothing adds nothing
    const float t = rt[row], l = rl[row], rlr = rrl[row], rv = rr[row];
    const float* drow = dist + (size_t)i * Li;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + lane_pos(tx, q);
      if (j >= Li) continue;
      const float d = drow[j], sd = __fmul_rn(s, d);
      if (!kept(d, sd, t, mode)) continue;
      const float w = div_rn(expf(__fsub_rn(m, sd)), l, rlr);
      part -= w * (acc[a][q] - rv) * d;
    }
  }
  red[tid] = part;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  if (tid == 0) partial[slot_out] = red[0];
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

// dv_idx, dv_cnt: the plan's dv lists, or null (a global op: every step);
// bm: input columns a block (128, 64 or 32); the reduction is cut into
// `splits` ranges of `chunk` 16-row steps; part: scratch of (splits, B,
// Li, H*V) floats where splits > 1, else null; vecd: dist's rows 16-byte
// aligned; vecv: cotangent and dv columns in aligned fours
extern "C" int posatt_tf_fixed_bwd_dv(const float* dist, const float* thr, const float* scale,
                                      const float* g, const float* stats, const int* dv_idx,
                                      const int* dv_cnt, float* dv, float* part, int B,
                                      int Lo, int Li, int H, int V, int mode, int bm, int splits,
                                      int chunk, int vecd, int vecv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ColPlan p = col_plan(B, V);
  dim3 grid(cdiv(Li, bm), p.tiles, H * splits);
  float* dst = splits > 1 ? part : dv;
  cudaError_t err;
  if (bm == 128)
    err = launch_dv<128>(grid, st, dist, thr, scale, g, stats, dv_idx, dv_cnt, dst, B, Lo, Li,
                         H, V, mode, p, chunk, vecd, vecv);
  else if (bm == 64)
    err = launch_dv<64>(grid, st, dist, thr, scale, g, stats, dv_idx, dv_cnt, dst, B, Lo, Li,
                        H, V, mode, p, chunk, vecd, vecv);
  else if (bm == 32)
    err = launch_dv<32>(grid, st, dist, thr, scale, g, stats, dv_idx, dv_cnt, dst, B, Lo, Li,
                        H, V, mode, p, chunk, vecd, vecv);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, dv, (size_t)B * Li * H * V, splits, st);
}

// tiles: the plan's tile flags, or null (a global op); scratch: rvec (H *
// Lo) and partial (H * splits * ceil(Lo / 128) * ceil(Li / 128)); the
// contraction over B * V pairs is cut into `splits` ranges of kchunk (a
// multiple of 16)
extern "C" int posatt_tf_fixed_bwd_dscale(const float* dist, const float* thr,
                                          const float* scale, const float* values,
                                          const float* out, const float* g, const float* stats,
                                          const int* tiles, float* rvec, float* partial,
                                          float* ds, int B, int Lo, int Li, int H, int V,
                                          int mode, int splits, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = THREADS / 32;
  r_kernel<<<cdiv(H * Lo, rows_per_block), THREADS, 0, st>>>(g, out, rvec, B, Lo, H, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dscale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(Lo, BM), cdiv(Li, BN), H * splits);
  dscale_kernel<<<grid, THREADS, DS_SMEM, st>>>(dist, thr, scale, values, g, stats, tiles, rvec,
                                                partial, B, Lo, Li, H, V, mode, splits, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<H, THREADS, 0, st>>>(partial, ds, (int)(splits * grid.x * grid.y));
  return cudaGetLastError();
}
