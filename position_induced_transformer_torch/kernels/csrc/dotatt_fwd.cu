// Dot-product attention (#14), forward, hand-written for Hopper (sm_90a),
// float32 throughout. No Pallas kernel to replace: the JAX package computes
// this attention with XLA inside MultiHeadSelfAtt and SelfMultiHeadPosAtt
// (position_induced_transformer_tpu/models/pit_tf.py:181-195 and :230-266),
// the attention of the TF family's ablation variants (lite and transformer:
// self; selfpit: hybrid).
//
//   dotatt_fwd   out[b, i, h*V + c] = sum_j softmax_j(x[b,h,i,:]) v[b, j, h*V + c]
//                stats (2, B, H, L): m (each row's largest logit) and
//                l (sum_j exp(x_ij - m)), which the backward reads
//
// with the logits x of dotatt.cuh (self: q.k / sqrt(V); hybrid: minus the
// scaled distances of one (L, L) matrix the batch shares, masked above the
// per-head row thresholds t (H, L)).
//
// What bounds it on this card: 4*V operations per (sample, head, row,
// column) entry (the logit and its weight's product with v), against
// 12*V bytes per row: the f32 CUDA-core rate for any L past a few dozen.
//
// Design (simple, right first): a block owns 64 query rows of one (sample,
// head); its q tile stays in shared memory while k and v stream through in
// tiles of 64 (32 at V > 128) rows, two cp.async stages deep. Each thread
// computes a 4 x 4 (4 x 2) patch of the logits from float4 reads, the 16
// threads of a row group keep the row's running max and sum (online
// softmax, shuffles in a fixed order), the weights go through shared memory
// into the thread's 4 rows x VP/16 columns of the output, rescaled when the
// max moves; the epilogue divides by the sum. No tensor cores, no
// --use_fast_math: the exp, the division and the rounding of the logits are
// IEEE's.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "dotatt.cuh"

namespace dotatt {

template <int VP, bool HYB>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dist,
               const float* __restrict__ thr, const float* __restrict__ scale,
               float* __restrict__ out, float* __restrict__ stats, int B, int L, int H, int V,
               float sd, int vec) {
  using T = FwdTiles<VP>;
  constexpr int BM = T::BM, BN = T::BN, LD = T::LD, LDP = T::LDP;
  constexpr int RM = BM / 16, RN = BN / 16, CV = VP / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BM * LD;       // 2 stages
  float* sV = sK + 2 * BN * LD;   // 2 stages
  float* sP = sV + 2 * BN * LD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int HV = H * V;
  const size_t base = (size_t)b * L * HV + (size_t)h * V;

  stage<BM, VP, LD>(sQ, q + base, row0, L, V, HV, vec);
  stage<BN, VP, LD>(sK, k + base, 0, L, V, HV, vec);
  stage<BN, VP, LD>(sV, v + base, 0, L, V, HV, vec);
  cp_commit();

  float sc = 0.f, t[RM];
  const float* drow[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = row0 + ty + 16 * a;
    t[a] = INFINITY;
    drow[a] = nullptr;
    if (HYB && i < L) {
      drow[a] = dist + (size_t)i * L;
      if (thr) t[a] = thr[(size_t)h * L + i];
    }
  }
  if (HYB) sc = scale[h];

  float m[RM], l[RM], o[RM][CV];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) o[a][c] = 0.f;
  }

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

    float s[RM][RN];
    dot_tile<RM, RN, VP, LD>(sQ, sK + st * BN * LD, ty, tx, s);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        s[a][c] = logit<HYB>(s[a][c], sd, drow[a], jt * BN + tx + 16 * c, L, sc, t[a]);
        mx = fmaxf(mx, s[a][c]);
      }
      const float mnew = fmaxf(m[a], group_max(mx));
      const float alpha = expf(m[a] - mnew);  // 0 on the first tile (m = -inf)
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        s[a][c] = expf(s[a][c] - mnew);
        rs += s[a][c];
      }
      l[a] = l[a] * alpha + group_sum(rs);
      m[a] = mnew;
#pragma unroll
      for (int c = 0; c < CV; ++c) o[a][c] *= alpha;
#pragma unroll
      for (int c = 0; c < RN; ++c) sP[(ty + 16 * a) * LDP + tx + 16 * c] = s[a][c];
    }
    __syncthreads();
    apply_tile<RM, CV, BN, LDP, LD>(sP, sV + st * BN * LD, ty, tx, o);
    __syncthreads();  // the next step overwrites this stage and the weights
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = row0 + ty + 16 * a;
    if (i >= L) continue;
    float* orow = out + (size_t)b * L * HV + (size_t)i * HV + (size_t)h * V;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int col = tx + 16 * c;
      if (col < V) orow[col] = __fdiv_rn(o[a][c], l[a]);
    }
    if (tx == 0) {
      const size_t at = ((size_t)b * H + h) * L + i;
      stats[at] = m[a];
      stats[(size_t)B * H * L + at] = l[a];
    }
  }
}

template <int VP, bool HYB>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* q, const float* k, const float* v,
                       const float* dist, const float* thr, const float* scale, float* out,
                       float* stats, int B, int L, int H, int V, float sd, int vec) {
  constexpr int smem = FwdTiles<VP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<VP, HYB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<VP, HYB><<<grid, THREADS, smem, st>>>(q, k, v, dist, thr, scale, out, stats, B, L,
                                                   H, V, sd, vec);
  return cudaGetLastError();
}

template <bool HYB>
cudaError_t dispatch_fwd(int vp, dim3 grid, cudaStream_t st, const float* q, const float* k,
                         const float* v, const float* dist, const float* thr, const float* scale,
                         float* out, float* stats, int B, int L, int H, int V, float sd, int vec) {
  switch (vp) {
    case 16: return launch_fwd<16, HYB>(grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 32: return launch_fwd<32, HYB>(grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 64: return launch_fwd<64, HYB>(grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 128: return launch_fwd<128, HYB>(grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 256: return launch_fwd<256, HYB>(grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dotatt

// q, k, v, out: (B, L, H*V); stats: (2, B, H, L). dist (L, L), thr (H, L)
// or null, scale (H,): hybrid mode only (dist null: self mode). vp: V
// rounded up to 16, 32, 64, 128 or 256; sd: the f32 square root of V.
extern "C" int dotatt_fwd(const float* q, const float* k, const float* v, const float* dist,
                          const float* thr, const float* scale, float* out, float* stats, int B,
                          int L, int H, int V, int vp, int vec, float sd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || H < 1 || V < 1 || V > vp || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(dotatt::cdiv(L, 64), H, B);
  return dist ? dotatt::dispatch_fwd<true>(vp, grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H,
                                   V, sd, vec)
              : dotatt::dispatch_fwd<false>(vp, grid, st, q, k, v, dist, thr, scale, out, stats, B, L, H,
                                    V, sd, vec);
}
