// Dot-product attention (#14), backward, hand-written for Hopper (sm_90a),
// float32 throughout: the gradients of dotatt_fwd.cu's output (no Pallas
// kernel to replace: the JAX package takes them by autodiff of XLA's
// MultiHeadSelfAtt and SelfMultiHeadPosAtt,
// position_induced_transformer_tpu/models/pit_tf.py:163-267). With the
// forward's logits x, its row stats m and l, the weights
// p_ij = exp(x_ij - m_i) / l_i and a cotangent g of the output:
//
//   delta_i  = sum_c g[i, c] out[i, c]
//   dp_ij    = sum_c g[i, c] v[j, c]
//   ds_ij    = p_ij (dp_ij - delta_i)                the logits' gradient
//   dq_i     = sum_j ds_ij k_j / sd                  dk_j = sum_i ds_ij q_i / sd
//   dv_j     = sum_i p_ij g_i
//   dscale_h = -sum_{b,i,j} ds_ij d_ij keep_ij       (hybrid: d logit / d sc_h)
//
// Two C entry points, the FlashAttention-2 schedule done simply:
//
//   dotatt_bwd_dq    dq (B, L, H*V), delta (B, H, L) and, hybrid, dscale (H,):
//                    dq_kernel (a block owns BM query rows of one (sample,
//                    head), computes their delta from g and out, streams k
//                    and v in two cp.async stages, and writes one partial of
//                    dscale), then reduce_kernel (each head's partials
//                    summed in a fixed order: the same bits every run)
//   dotatt_bwd_dkdv  dk, dv (B, L, H*V): dkv_kernel (a block owns BN key
//                    rows of one (sample, head) with k and v resident, and
//                    streams q and g in two cp.async stages; reads dq's
//                    delta, so it runs after dotatt_bwd_dq)
//
// Every step recomputes the logits and weights from q, k and the row stats,
// as the forward rounds them. No float atomics: every output is one
// thread's sum in a fixed order.
//
// What bounds them on this card: 8*V operations per (sample, head, row,
// column) entry each (two products for the logits and dp, two for the
// gradients), the f32 CUDA-core rate.

#include "dotatt.cuh"

namespace dotatt {

template <int VP, bool HYB>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ g, const float* __restrict__ stats,
              const float* __restrict__ dist, const float* __restrict__ thr,
              const float* __restrict__ scale, float* __restrict__ dq,
              float* __restrict__ delta, float* __restrict__ partial, int B, int L, int H, int V,
              float sd, int vec) {
  using T = DqTiles<VP>;
  constexpr int BM = T::BM, BN = T::BN, LD = T::LD, LDP = T::LDP;
  constexpr int RM = BM / 16, RN = BN / 16, CV = VP / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sG = sQ + BM * LD;
  float* sK = sG + BM * LD;       // 2 stages
  float* sV = sK + 2 * BN * LD;   // 2 stages
  float* sS = sV + 2 * BN * LD;   // the logits' gradient

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int HV = H * V;
  const size_t base = (size_t)b * L * HV + (size_t)h * V;

  stage<BM, VP, LD>(sQ, q + base, row0, L, V, HV, vec);
  stage<BM, VP, LD>(sG, g + base, row0, L, V, HV, vec);
  cp_commit();
  stage<BN, VP, LD>(sK, k + base, 0, L, V, HV, vec);
  stage<BN, VP, LD>(sV, v + base, 0, L, V, HV, vec);
  cp_commit();

  float sc = 0.f, t[RM], m[RM], l[RM], dl[RM];
  const float* drow[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = row0 + ty + 16 * a;
    t[a] = INFINITY;
    drow[a] = nullptr;
    m[a] = 0.f;
    l[a] = 1.f;
    if (i < L) {
      const size_t at = ((size_t)b * H + h) * L + i;
      m[a] = stats[at];
      l[a] = stats[(size_t)B * H * L + at];
      if (HYB) {
        drow[a] = dist + (size_t)i * L;
        if (thr) t[a] = thr[(size_t)h * L + i];
      }
    }
  }
  if (HYB) sc = scale[h];

  cp_wait<1>();  // q and g have landed
  __syncthreads();
  // delta of each row: this thread's columns, then the row group's, in order
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = row0 + ty + 16 * a;
    float acc = 0.f;
    if (i < L) {
      const float* orow = out + base + (size_t)i * HV;
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const int col = tx + 16 * c;
        if (col < V) acc = fmaf(sG[(ty + 16 * a) * LD + col], orow[col], acc);
      }
    }
    dl[a] = group_sum(acc);
    if (i < L && tx == 0) delta[((size_t)b * H + h) * L + i] = dl[a];
  }

  float acc[RM][CV];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[a][c] = 0.f;
  float dsum = 0.f;  // this thread's share of sum ds * d * keep

  const int nT = cdiv(L, BN);
  for (int jt = 0; jt < nT; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < nT) {
      stage<BN, VP, LD>(sK + (st ^ 1) * BN * LD, k + base, (jt + 1) * BN, L, V, HV, vec);
      stage<BN, VP, LD>(sV + (st ^ 1) * BN * LD, v + base, (jt + 1) * BN, L, V, HV, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
    dot_tile<RM, RN, VP, LD>(sQ, sK + st * BN * LD, ty, tx, s);
    dot_tile<RM, RN, VP, LD>(sG, sV + st * BN * LD, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = row0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int j = jt * BN + tx + 16 * c;
        const float x = logit<HYB>(s[a][c], sd, drow[a], j, L, sc, t[a]);
        const float p = i < L ? __fdiv_rn(expf(x - m[a]), l[a]) : 0.f;
        const float ds = p * (dp[a][c] - dl[a]);
        if (HYB && i < L && j < L) {
          const float sdist = __fmul_rn(__ldg(drow[a] + j), sc);
          if (sdist <= t[a]) dsum = fmaf(ds, __ldg(drow[a] + j), dsum);
        }
        sS[(ty + 16 * a) * LDP + tx + 16 * c] = ds;
      }
    }
    __syncthreads();
    apply_tile<RM, CV, BN, LDP, LD>(sS, sK + st * BN * LD, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = row0 + ty + 16 * a;
    if (i >= L) continue;
    float* row = dq + base + (size_t)i * HV;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int col = tx + 16 * c;
      if (col < V) row[col] = __fdiv_rn(acc[a][c], sd);
    }
  }
  if (HYB) {  // the block's partial: warps in order, lanes in a fixed tree
    __shared__ float wsum[THREADS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if ((tid & 31) == 0) wsum[tid / 32] = dsum;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) total += wsum[w];
      partial[(size_t)h * gridDim.x * B + (size_t)b * gridDim.x + blockIdx.x] = total;
    }
  }
}

// ds[h] = -(sum of head h's n partials, in order)
__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ ds, int n) {
  if (threadIdx.x != 0) return;
  const float* p = partial + (size_t)blockIdx.x * n;
  float total = 0.f;
  for (int i = 0; i < n; ++i) total += p[i];
  ds[blockIdx.x] = -total;
}

template <int VP, bool HYB>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ stats, const float* __restrict__ delta,
               const float* __restrict__ dist, const float* __restrict__ thr,
               const float* __restrict__ scale, float* __restrict__ dk, float* __restrict__ dv,
               int B, int L, int H, int V, float sd, int vec) {
  using T = DkvTiles<VP>;
  constexpr int BM = T::BM, BN = T::BN, LD = T::LD, LDP = T::LDP;
  constexpr int RM = BM / 16, RN = BN / 16, CV = VP / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;       // 2 stages
  float* sG = sQ + 2 * BM * LD;   // 2 stages
  float* sP = sG + 2 * BM * LD;
  float* sS = sP + BM * LDP;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int HV = H * V;
  const size_t base = (size_t)b * L * HV + (size_t)h * V;
  const size_t srow = ((size_t)b * H + h) * L;  // this (sample, head)'s stats and delta

  stage<BN, VP, LD>(sK, k + base, col0, L, V, HV, vec);
  stage<BN, VP, LD>(sV, v + base, col0, L, V, HV, vec);
  stage<BM, VP, LD>(sQ, q + base, 0, L, V, HV, vec);
  stage<BM, VP, LD>(sG, g + base, 0, L, V, HV, vec);
  cp_commit();
  const float sc = HYB ? scale[h] : 0.f;

  float ak[RN][CV], av[RN][CV];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < CV; ++c) ak[r][c] = av[r][c] = 0.f;

  const int nT = cdiv(L, BM);
  for (int it = 0; it < nT; ++it) {
    const int st = it & 1;
    if (it + 1 < nT) {
      stage<BM, VP, LD>(sQ + (st ^ 1) * BM * LD, q + base, (it + 1) * BM, L, V, HV, vec);
      stage<BM, VP, LD>(sG + (st ^ 1) * BM * LD, g + base, (it + 1) * BM, L, V, HV, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const float* q_t = sQ + st * BM * LD;
    const float* g_t = sG + st * BM * LD;
    float s[RM][RN], dp[RM][RN];
    dot_tile<RM, RN, VP, LD>(q_t, sK, ty, tx, s);
    dot_tile<RM, RN, VP, LD>(g_t, sV, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = it * BM + ty + 16 * a;
      float m = 0.f, l = 1.f, dl = 0.f, t = INFINITY;
      const float* drow = nullptr;
      if (i < L) {
        m = __ldg(stats + srow + i);
        l = __ldg(stats + (size_t)B * H * L + srow + i);
        dl = __ldg(delta + srow + i);
        if (HYB) {
          drow = dist + (size_t)i * L;
          if (thr) t = __ldg(thr + (size_t)h * L + i);
        }
      }
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int j = col0 + tx + 16 * c;
        const float x = logit<HYB>(s[a][c], sd, drow, j, L, sc, t);
        const float p = i < L ? __fdiv_rn(expf(x - m), l) : 0.f;
        sP[(ty + 16 * a) * LDP + tx + 16 * c] = p;
        sS[(ty + 16 * a) * LDP + tx + 16 * c] = p * (dp[a][c] - dl);
      }
    }
    __syncthreads();
    apply_tile_t<RN, CV, BM, LDP, LD>(sP, g_t, ty, tx, av);
    apply_tile_t<RN, CV, BM, LDP, LD>(sS, q_t, ty, tx, ak);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int j = col0 + ty + 16 * r;
    if (j >= L) continue;
    float* krow = dk + base + (size_t)j * HV;
    float* vrow = dv + base + (size_t)j * HV;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int col = tx + 16 * c;
      if (col < V) {
        krow[col] = __fdiv_rn(ak[r][c], sd);
        vrow[col] = av[r][c];
      }
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int VP, bool HYB>
cudaError_t launch_dq(cudaStream_t st, const float* q, const float* k, const float* v,
                      const float* out, const float* g, const float* stats, const float* dist,
                      const float* thr, const float* scale, float* dq, float* delta,
                      float* partial, float* ds, int B, int L, int H, int V, float sd, int vec) {
  using T = DqTiles<VP>;
  cudaError_t err = prepare(dq_kernel<VP, HYB>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(L, T::BM), H, B);
  dq_kernel<VP, HYB><<<grid, THREADS, T::SMEM, st>>>(q, k, v, out, g, stats, dist, thr, scale,
                                                     dq, delta, partial, B, L, H, V, sd, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !HYB) return err;
  reduce_kernel<<<H, 32, 0, st>>>(partial, ds, (int)(grid.x * B));
  return cudaGetLastError();
}

template <int VP, bool HYB>
cudaError_t launch_dkv(cudaStream_t st, const float* q, const float* k, const float* v,
                       const float* g, const float* stats, const float* delta, const float* dist,
                       const float* thr, const float* scale, float* dk, float* dv, int B, int L,
                       int H, int V, float sd, int vec) {
  using T = DkvTiles<VP>;
  cudaError_t err = prepare(dkv_kernel<VP, HYB>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(L, T::BN), H, B);
  dkv_kernel<VP, HYB><<<grid, THREADS, T::SMEM, st>>>(q, k, v, g, stats, delta, dist, thr, scale,
                                                      dk, dv, B, L, H, V, sd, vec);
  return cudaGetLastError();
}

#define DOTATT_VP_SWITCH(vp, CALL) \
  switch (vp) {                    \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    case 64: return CALL(64);      \
    case 128: return CALL(128);    \
    case 256: return CALL(256);    \
    default: return cudaErrorInvalidValue; \
  }

bool bad_shape(int B, int L, int H, int V, int vp) {
  return B < 1 || L < 1 || H < 1 || V < 1 || V > vp || B > 65535 || H > 65535;
}

}  // namespace dotatt

// The dq entry point. dq (B, L, H*V); delta (B, H, L), which dkdv reads;
// hybrid (dist not null): partial (H, ceil(L / BM) * B) scratch and ds (H,),
// where BM is dotatt_bwd_rows(vp).
extern "C" int dotatt_bwd_dq(const float* q, const float* k, const float* v, const float* out,
                             const float* g, const float* stats, const float* dist,
                             const float* thr, const float* scale, float* dq, float* delta,
                             float* partial, float* ds, int B, int L, int H, int V, int vp, int vec,
                             float sd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dotatt::bad_shape(B, L, H, V, vp)) return cudaErrorInvalidValue;
#define DQ_CALL(VP)                                                                          \
  (dist ? dotatt::launch_dq<VP, true>(st, q, k, v, out, g, stats, dist, thr, scale, dq, delta,     \
                              partial, ds, B, L, H, V, sd, vec)                              \
        : dotatt::launch_dq<VP, false>(st, q, k, v, out, g, stats, dist, thr, scale, dq, delta,    \
                               partial, ds, B, L, H, V, sd, vec))
  DOTATT_VP_SWITCH(vp, DQ_CALL)
#undef DQ_CALL
}

// Query rows a dq block owns at the padded width vp: sizes dq's partials.
extern "C" int dotatt_bwd_rows(int vp) { return vp >= 256 ? dotatt::DqTiles<256>::BM : dotatt::DqTiles<64>::BM; }

// The dk/dv entry point: dk, dv (B, L, H*V), from dq's delta.
extern "C" int dotatt_bwd_dkdv(const float* q, const float* k, const float* v, const float* g,
                               const float* stats, const float* delta, const float* dist,
                               const float* thr, const float* scale, float* dk, float* dv, int B,
                               int L, int H, int V, int vp, int vec, float sd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dotatt::bad_shape(B, L, H, V, vp)) return cudaErrorInvalidValue;
#define DKV_CALL(VP)                                                                          \
  (dist ? dotatt::launch_dkv<VP, true>(st, q, k, v, g, stats, delta, dist, thr, scale, dk, dv, B, L, \
                               H, V, sd, vec)                                                 \
        : dotatt::launch_dkv<VP, false>(st, q, k, v, g, stats, delta, dist, thr, scale, dk, dv, B, L, \
                                H, V, sd, vec))
  DOTATT_VP_SWITCH(vp, DKV_CALL)
#undef DKV_CALL
}
