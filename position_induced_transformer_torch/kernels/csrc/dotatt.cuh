// Dot-product attention (#14), shared by dotatt_fwd.cu and dotatt_bwd.cu:
// the tile shapes, the cp.async staging, the logits and the 3xTF32
// tensor-core products.
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
//
// The products (q.k and every other sum over V or over keys) run on the
// tensor cores as 3xTF32: mma.sync m16n8k8 with tf32 operands and f32
// accumulation, each chain of mma short (mma3, add3). Each f32 operand x
// is split into big = RNA_tf32(x) and small = RNA_tf32(x - big) (10
// explicit mantissa bits each, round to nearest, ties away), and acc +=
// small_a big_b + big_a small_b + big_a big_b: small x small (about 2^-22
// of the product) is dropped, below the
// f32 rounding of the sums themselves (tests/test_torch_dotatt_tf32.py
// emulates the scheme and holds it to the f32 and float64 products). A
// warp owns 16 rows of one operand (its A fragments); the other streams
// through shared memory as B fragments, split once by the block into TF32
// planes or by each warp as it reads them (Tiles::PRE).
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32; lane = 4 g + t):
//   A (16 x 8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product's C fragment feeds the next product's A operand without a
// shuffle or a trip through shared memory: the k index of an mma is a
// summation index, so lane (g, t) hands its own c0, c2, c1, c3 over as
// a0..a3 and reads the B rows 2t and 2t+1 for the k indices t and t+4
// (load_b_pairs): the same sum over the same 8 terms, in the mma's order.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace dotatt {

constexpr int ROWS_MAX = 64;  // rows a block owns, but for split 4
constexpr int CG = 4;  // output n-tiles a warp accumulates side by side
constexpr int SMEM_MAX = 232448;  // the most dynamic shared memory a block can have

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tiles of one kernel at padded width VP with the key (or query) split
// SPLIT: 1, four warps, each owning 16 rows of a 64-row block and reading
// every streamed row; 2, eight warps, two on each 16 rows of a 64-row
// block, each reading half of every streamed tile; 4, four warps owning the
// same 16 rows, each reading a quarter (few-block ops). A split's partial
// sums are combined at the end, in the order of the parts.
//   BN       rows streamed a stage (keys: forward, dq; queries: dk/dv)
//   RING     the cp.async ring's depth
//   PRE      the streamed tiles land raw in the ring (rows of VP) and the
//            block splits each once into tf32 big and small planes (rows of
//            LD), which every warp reads without splitting; else the ring's
//            rows are padded to LD and each warp splits what it reads (where
//            the planes would not fit beside the rest, or measured slower)
//   OWN_REG  the owned rows' operands split once into registers; else raw
//            in shared memory, split at each read
//   NOWN     owned operands (q; q and g; k and v)
//   NSCAL    per-streamed-row scalars staged beside them (dk/dv: m, l, delta, t)
//   SMEM     bytes of dynamic shared memory
template <int VP, int SPLIT, int BN_, int RING_, bool PRE_, bool OWN_REG_, int NOWN, int NSCAL>
struct Tiles {
  static constexpr int BN = BN_, RING = RING_;
  static constexpr bool PRE = PRE_, OWN_REG = OWN_REG_, OWN_SM = !OWN_REG_;
  static constexpr int NW = SPLIT == 2 ? 8 : 4;     // warps a block
  static constexpr int ROWS = 16 * NW / SPLIT;     // rows a block owns
  static constexpr int BNW = BN / SPLIT;           // streamed rows a warp reads a stage
  static constexpr int NT = BNW / 8;               // their n-tiles (or k-steps)
  static constexpr int KS = VP / 8;                // k-steps (or n-tiles) over the head width
  static constexpr int LD = VP + 4;  // row stride a warp reads: conflict-free fragments
  static constexpr int LDR = PRE ? VP : LD;        // a ring row's stride
  static constexpr int OWN = OWN_SM ? NOWN * ROWS * LD : 0;       // floats
  static constexpr int STAGE = 2 * BN * LDR + NSCAL * BN;         // floats a ring stage
  static constexpr int PLANE = 2 * BN * LD;                       // floats a plane (both arrays)
  static constexpr int PLANES =  // big, small, the scalars and (dk/dv) RN(1 / l)
      PRE ? 2 * PLANE + (NSCAL ? NSCAL + 1 : 0) * BN : 0;
  static constexpr int FLOATS = OWN + RING * STAGE + PLANES;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(BNW % 8 == 0, "a warp reads whole 8-row tiles");
  static_assert(SMEM <= SMEM_MAX, "tiles above the card's shared memory");
  static_assert(SPLIT == 1 || SPLIT * ROWS * (VP + 2) <= FLOATS, "the combine reuses the tiles");
};

// The choices of splits 1 and 2 by padded width, as measured on the H100
// (the source notes of dotatt_fwd.cu and dotatt_bwd.cu): rows streamed a
// stage, PRE, OWN_REG, the ring's depth and the split.
struct Cfg {
  int bn;
  bool pre, own_reg;
  int ring;
  int split;  // 1, or 2 where shared memory leaves room for one block an SM
};
constexpr Cfg fwd_cfg(int VP) {
  return VP <= 32 ? Cfg{64, true, true, 2, 1} : VP == 64 ? Cfg{32, true, true, 2, 1}
       : VP == 128 ? Cfg{32, false, false, 2, 1} : Cfg{32, false, false, 2, 2};
}
constexpr Cfg dq_cfg(int VP) {
  return VP == 16 ? Cfg{32, true, true, 2, 1} : VP == 32 ? Cfg{64, true, false, 2, 1}
       : VP == 64 ? Cfg{32, true, false, 2, 1} : VP == 128 ? Cfg{32, false, false, 3, 2}
                                            : Cfg{16, false, false, 2, 2};
}
constexpr Cfg dkv_cfg(int VP) {
  return VP == 16 ? Cfg{32, true, true, 2, 1} : VP == 32 ? Cfg{64, true, false, 2, 1}
       : VP == 64 ? Cfg{32, true, false, 2, 1} : VP == 128 ? Cfg{32, true, false, 2, 2}
                                            : Cfg{16, false, false, 2, 2};
}
// Split 4 (its tiles hold VP 16 x 16 rows): rows streamed a stage; the
// streamed tiles split once by the block up to VP 128, the owned rows
// split into registers (the forward up to VP 128, the backward up to 32).
template <int VP>
constexpr int split4_bn() { return VP <= 32 ? 64 : 32; }

// The kernel's choices: the forward owns one operand, dk/dv stage scalars
constexpr Cfg cfg_of(int VP, int NOWN, int NSCAL) {
  return NOWN == 1 ? fwd_cfg(VP) : NSCAL ? dkv_cfg(VP) : dq_cfg(VP);
}

template <int VP, int SPLIT, int NOWN, int NSCAL, int OWN_REG_MAX>
using TilesOf = Tiles<VP, SPLIT, SPLIT == 4 ? split4_bn<VP>() : cfg_of(VP, NOWN, NSCAL).bn,
                      SPLIT == 4 ? (VP <= 128 ? 2 : NOWN == 1 ? 3 : 2)
                                 : cfg_of(VP, NOWN, NSCAL).ring,
                      SPLIT == 4 ? VP <= 128 : cfg_of(VP, NOWN, NSCAL).pre,
                      SPLIT == 4 ? VP <= OWN_REG_MAX : cfg_of(VP, NOWN, NSCAL).own_reg, NOWN,
                      NSCAL>;
// The forward: q owned, k and v streamed.
template <int VP, int SPLIT>
using FwdTiles = TilesOf<VP, SPLIT, 1, 0, 128>;
// dq: q and g owned, k and v streamed.
template <int VP, int SPLIT>
using DqTiles = TilesOf<VP, SPLIT, 2, 0, 32>;
// dk/dv: k and v owned, q, g and the query rows' m, l, delta and
// threshold streamed.
template <int VP, int SPLIT>
using DkvTiles = TilesOf<VP, SPLIT, 2, 4, 32>;

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
    for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const bool ok = row0 + r < L && c < V;
      cp16(sm + r * LD + c, ok ? g + (size_t)(row0 + r) * HV + c : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * VP; idx += blockDim.x) {
      const int r = idx / VP, c = idx % VP;
      const bool ok = row0 + r < L && c < V;
      cp4(sm + r * LD + c, ok ? g + (size_t)(row0 + r) * HV + c : g, ok);
    }
  }
}

// ------------------------------------------------------------ 3xTF32 products

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// RNA_tf32(x): x rounded to 10 explicit mantissa bits, to nearest, ties
// away from zero (cvt.rna.tf32.f32's rounding, for the finite operands
// here), by integer arithmetic on the bits: adding half a tf32 ulp to the
// magnitude and clearing the 13 bits below; the cvt instruction measured
// slower on the H100.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ a rest below 2^-22 |x|), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));  // exact: x and big share the top bits
}

template <int N>
struct Frag {  // N tf32 operand registers, split into big and small halves
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], f.big[i], f.small[i]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a b[i] in 3xTF32: the two cross terms, then big x big, each
// pass over the N accumulators in turn, so that consecutive mma are
// independent. The tensor cores add each product's 8 terms to the
// accumulator and truncate the sum to f32 (toward zero), so a long chain
// into one accumulator drifts toward zero: a chain stays within one tile
// of 8-row k-steps, and the sums across tiles are taken in IEEE f32 (add3,
// the callers' epilogues).
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const Frag<4>& a, const Frag<2> (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.big, b[i].big);
}

// d[i] += a b[i] for the k-steps of one head width, in pairs: each pair's
// products into fresh accumulators, the results added to d in IEEE f32, so
// the truncation applies to 16 terms' partial sums and not to the running
// sums (q.k, g.v). Call with kk = 0, 1, ..., KS - 1 in turn, t the pair's
// accumulators.
template <int N>
__device__ __forceinline__ void add3(float (&d)[N][4], float (&t)[N][4], int kk, int KS,
                                     const Frag<4>& a, const Frag<2> (&b)[N]) {
  if (kk % 2 == 0) zero(t);
  mma3(t, a, b);
  if (kk % 2 == 1 || kk == KS - 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] = __fadd_rn(d[i][e], t[i][e]);
  }
}

// ------------------------------------------------------------ fragments

// A fragment of a warp's 16 rows at k-step kk from shared memory (row
// stride LD, s at the warp's row 0, column 0).
template <int LD>
__device__ __forceinline__ void load_a(float (&a)[4], const float* s, int kk, int g, int t) {
  const float* p = s + g * LD + kk * 8 + t;
  a[0] = p[0];
  a[1] = p[8 * LD];
  a[2] = p[4];
  a[3] = p[8 * LD + 4];
}

// The same fragments of rows [r0, r0 + 16) of one head, for every k-step,
// from device memory into registers; zeros past L and past V.
template <int KS>
__device__ __forceinline__ void load_a_rows(float (&a)[KS][4], const float* x, int r0, int L,
                                            int V, int HV, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1), col = kk * 8 + t + 4 * (e >> 1);
      a[kk][e] = row < L && col < V ? __ldg(x + (size_t)row * HV + col) : 0.f;
    }
}

// B fragment whose n index runs over staged rows and k over columns:
// b0 = M[g][t], b1 = M[g][t + 4] (s at the tile's row 0, column k0). For
// x . y over the head width.
template <int LD>
__device__ __forceinline__ void load_b(float (&b)[2], const float* s, int g, int t) {
  const float* p = s + g * LD + t;
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment whose k index runs over staged rows, in the pairs a C
// fragment holds, and n over columns: b0 = M[2t][g], b1 = M[2t + 1][g]
// (s at the tile's row 0, column n0). For weights times rows.
template <int LD>
__device__ __forceinline__ void load_b_pairs(float (&b)[2], const float* s, int g, int t) {
  const float* p = s + 2 * t * LD + g;
  b[0] = p[0];
  b[1] = p[LD];
}

template <int LD>
__device__ __forceinline__ Frag<2> load_b_split(const float* s, int g, int t) {
  float b[2];
  load_b<LD>(b, s, g, t);
  return split(b);
}

template <int LD>
__device__ __forceinline__ Frag<2> load_b_pairs_split(const float* s, int g, int t) {
  float b[2];
  load_b_pairs<LD>(b, s, g, t);
  return split(b);
}

// The same two fragments from a block's split planes (big and small at the
// same offset): no splitting in the warp.
template <int LD>
__device__ __forceinline__ Frag<2> load_b_pl(const float* big, const float* small, int g, int t) {
  const int o = g * LD + t;
  Frag<2> f;
  f.big[0] = __float_as_uint(big[o]);
  f.big[1] = __float_as_uint(big[o + 4]);
  f.small[0] = __float_as_uint(small[o]);
  f.small[1] = __float_as_uint(small[o + 4]);
  return f;
}

template <int LD>
__device__ __forceinline__ Frag<2> load_b_pairs_pl(const float* big, const float* small, int g,
                                                   int t) {
  const int o = 2 * t * LD + g;
  Frag<2> f;
  f.big[0] = __float_as_uint(big[o]);
  f.big[1] = __float_as_uint(big[o + LD]);
  f.small[0] = __float_as_uint(small[o]);
  f.small[1] = __float_as_uint(small[o + LD]);
  return f;
}

// Split R staged rows (stride VP) into the big and small planes (stride
// LD), four columns a thread at a time, and copy n scalars after them.
template <int R, int VP, int LD>
__device__ __forceinline__ void split_rows(float* big, float* small, const float* raw,
                                           float* scal_out = nullptr,
                                           const float* scal_in = nullptr, int n = 0) {
  constexpr int C4 = VP / 4;
  for (int idx = threadIdx.x; idx < R * C4; idx += blockDim.x) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * VP + c);
    uint4 b, s;
    split(x.x, b.x, s.x);
    split(x.y, b.y, s.y);
    split(x.z, b.z, s.z);
    split(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + r * LD + c) = b;
    *reinterpret_cast<uint4*>(small + r * LD + c) = s;
  }
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) scal_out[idx] = scal_in[idx];
}

// The owned rows' A fragments for every k-step, split once
template <int KS>
__device__ __forceinline__ void load_a_rows_split(Frag<4> (&f)[KS], const float* x, int r0, int L,
                                                  int V, int HV, int g, int t) {
  float a[KS][4];
  load_a_rows<KS>(a, x, r0, L, V, HV, g, t);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) f[kk] = split(a[kk]);
}

// A C fragment as the A operand of the next product (see the top)
__device__ __forceinline__ Frag<4> c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return split(a);
}

// ------------------------------------------------------------ logits

// The quad of lanes that shares C rows g and g + 8: reductions in a fixed order
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// RN(s / sd), given inv = RN(1 / sd): q = RN(s inv) is within an ulp of
// the quotient, and one correction by the exact residual s - q sd rounds
// it correctly (Markstein's theorem; IA-64's division). Three operations
// where __fdiv_rn takes a reciprocal, its refinement and a range check
// per call; for sd a power of two (V 16, 64, 256) the residual is 0.
__device__ __forceinline__ float div_rn(float s, float sd, float inv) {
  const float q = __fmul_rn(s, inv);
  return __fmaf_rn(__fmaf_rn(-q, sd, s), inv, q);
}

// The logit of (i, j) from the raw product s (see the top of this file);
// -inf past the last key column, so that it weighs nothing; inv = RN(1 /
// sd). Hybrid (hyb)
// reads one distance: d_row is dist's row i (null past L), t the row's
// threshold (+inf without one); keep and dd return whether the entry is
// kept and its distance (for dscale).
__device__ __forceinline__ float logit(float s, float sd, float inv, bool hyb, const float* d_row,
                                       int j, int L, float sc, float t, bool& keep, float& dd) {
  keep = false;
  dd = 0.f;
  if (j >= L) return -INFINITY;
  float x = div_rn(s, sd, inv);
  if (hyb) {
    dd = d_row ? __ldg(d_row + j) : 0.f;
    const float sdist = __fmul_rn(dd, sc);
    keep = sdist <= t;
    x = keep ? __fsub_rn(x, sdist) : -FLT_MAX;
  }
  return x;
}

// The streaming multiprocessors of the current device: the few-block rule
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Split the streamed rows four ways when a 64-row block per (sample, head)
// fills less than one wave of the card.
inline int split_of(int L, int H, int B) {
  return (long long)cdiv(L, ROWS_MAX) * H * B < sm_count() ? 4 : 1;
}

}  // namespace dotatt
