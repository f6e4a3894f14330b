// Dot-product attention (#14), shared by dotatt_fwd.cu and dotatt_bwd.cu:
// the tile shapes, the cp.async staging, the logits and the small products.
//
// Layout: q, k, v, out and their gradients are (B, L, H*V) float32, head h
// in columns [h*V, (h+1)*V) of each row (the JAX package's
// transpose(0, 2, 1, 3).reshape(B, L, hid) of its (B, H, L, V) tensors).
// Inside a block one head's V columns are staged zero-padded to VP (16, 32,
// 64, 128 or 256), so every product runs over VP terms; the pad adds zeros.
//
// The logit of query row i and key column j of head h, as the JAX package
// computes it (models/pit_tf.py:182-188 and :231-261), f32 throughout:
//
//   self:    x = RN(q_i . k_j / sd)                      sd = RN(sqrt(V))
//   hybrid:  s = RN(d_ij * sc_h)                         sc_h = tan(r_h)
//            x = RN(RN(q_i . k_j / sd) - s)  where s <= t_hi (or no t)
//            x = -FLT_MAX                    elsewhere
//
// JAX writes f32 max into a masked entry of the scaled distances and
// subtracts it, which gives -FLT_MAX: its weight is exactly 0, and a row
// that keeps nothing has equal logits everywhere, i.e. uniform weights,
// here as there. The division, the product and the difference are
// explicitly rounded (no contraction into an FMA), so the mask reads the
// same f32 products as the quantile that made t.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace dotatt {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16 owns rows, tx = tid % 16 columns

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The forward's tiles: BM query rows a block, BN key columns a step.
template <int VP>
struct FwdTiles {
  static constexpr int BM = 64;
  static constexpr int BN = VP >= 256 ? 32 : 64;
  static constexpr int LD = VP + 4;  // staged row stride: float4 reads, no bank conflicts
  static constexpr int LDP = BN + 4;
  static constexpr int SMEM = (BM * LD + 4 * BN * LD + BM * LDP) * 4;  // q, 2 x (k, v), p
};

// dQ's tiles (a block owns BM query rows; keys stream in BN steps).
template <int VP>
struct DqTiles {
  static constexpr int BM = VP >= 256 ? 32 : 64;
  static constexpr int BN = VP >= 256 ? 32 : 64;
  static constexpr int LD = VP + 4;
  static constexpr int LDP = BN + 4;
  static constexpr int SMEM = (2 * BM * LD + 4 * BN * LD + BM * LDP) * 4;  // q, do, 2 x (k, v), ds
};

// dK/dV's tiles (a block owns BN key columns; queries stream in BM steps).
template <int VP>
struct DkvTiles {
  static constexpr int BN = VP >= 256 ? 32 : 64;
  static constexpr int BM = VP >= 128 ? 32 : 64;
  static constexpr int LD = VP + 4;
  static constexpr int LDP = BN + 4;
  static constexpr int SMEM = (2 * BN * LD + 4 * BM * LD + 2 * BM * LDP) * 4;  // k, v, 2 x (q, do), p, ds
};

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage R rows [row0, row0 + R) of one head into sm (R x LD), zeros past L
// and past V. g: the head's column 0 of row 0 of this sample. vec: 16-byte
// copies (V % 4 == 0 and a 16-byte aligned tensor), else 4-byte ones.
template <int R, int VP, int LD>
__device__ __forceinline__ void stage(float* sm, const float* g, int row0, int L, int V, int HV,
                                      bool vec) {
  if (vec) {
    constexpr int CH = VP / 4;
    for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const bool ok = row0 + r < L && c < V;
      cp16(sm + r * LD + c, ok ? g + (size_t)(row0 + r) * HV + c : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * VP; idx += THREADS) {
      const int r = idx / VP, c = idx % VP;
      const bool ok = row0 + r < L && c < V;
      cp4(sm + r * LD + c, ok ? g + (size_t)(row0 + r) * HV + c : g, ok);
    }
  }
}

// ------------------------------------------------------------ products

// s[a][b] = sum_d A[ty + 16a][d] B[tx + 16b][d] over the staged VP columns,
// in order of d.
template <int RA, int RB, int VP, int LD>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ty, int tx,
                                         float (&s)[RA][RB]) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < VP; d += 4) {
    float4 x[RA], y[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) x[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < RB; ++b) y[b] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        float acc = s[a][b];
        acc = fmaf(x[a].x, y[b].x, acc);
        acc = fmaf(x[a].y, y[b].y, acc);
        acc = fmaf(x[a].z, y[b].z, acc);
        acc = fmaf(x[a].w, y[b].w, acc);
        s[a][b] = acc;
      }
  }
}

// acc[a][c] += sum_k W[ty + 16a][k] X[k][tx + 16c] over K staged rows, in
// order of k: W (rows x K, stride LDW) the weights, X (K x LD) the operand.
template <int RA, int CV, int K, int LDW, int LD>
__device__ __forceinline__ void apply_tile(const float* W, const float* X, int ty, int tx,
                                           float (&acc)[RA][CV]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 w[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) w[a] = *reinterpret_cast<const float4*>(W + (ty + 16 * a) * LDW + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float x = X[(k + kk) * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const float wa = kk == 0 ? w[a].x : kk == 1 ? w[a].y : kk == 2 ? w[a].z : w[a].w;
          acc[a][c] = fmaf(wa, x, acc[a][c]);
        }
      }
    }
  }
}

// acc[r][c] += sum_i W[i][ty + 16r] X[i][tx + 16c] over K staged rows i, in
// order of i: the transposed weights (dK and dV).
template <int RR, int CV, int K, int LDW, int LD>
__device__ __forceinline__ void apply_tile_t(const float* W, const float* X, int ty, int tx,
                                             float (&acc)[RR][CV]) {
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
    float w[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) w[r] = W[i * LDW + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const float x = X[i * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RR; ++r) acc[r][c] = fmaf(w[r], x, acc[r][c]);
    }
  }
}

// The 16 threads of a row group (same ty: lanes 16 apart never mix)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The logit of (i, j) from the raw product s (see the top of this file);
// -inf past the last key column, so that it weighs nothing. HYB reads one
// distance: d_row is dist's row i (null past L), t the row's threshold
// (+inf without one).
template <bool HYB>
__device__ __forceinline__ float logit(float s, float sd, const float* d_row, int j, int L,
                                       float sc, float t) {
  if (j >= L) return -INFINITY;
  float x = __fdiv_rn(s, sd);
  if (HYB) {
    const float dd = d_row ? __ldg(d_row + j) : 0.f;
    const float sdist = __fmul_rn(dd, sc);
    x = sdist <= t ? __fsub_rn(x, sdist) : -FLT_MAX;
  }
  return x;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

}  // namespace dotatt
