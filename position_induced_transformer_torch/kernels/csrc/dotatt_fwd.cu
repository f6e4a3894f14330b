// Dot-product attention (#14), forward, hand-written for Hopper (sm_90a),
// float32 in and out. No Pallas kernel to replace: the JAX package computes
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
// What bounds it on this card: two products of 2V operations per (sample,
// head, row, column) entry, run as 3xTF32: 3 x 4V tensor-core operations
// per kept entry against 495 dense TF32 TFLOP/s (mma.sync reaches about
// 322 here: scripts/mma_tf32_ceiling.cu), beside one IEEE exp; against 12V
// bytes per row read once at 3.35 TB/s. Operations bound every op of the
// variants past a few hundred tokens. In practice the warps' latency bounds
// it: a warp issues split, load and softmax work between its mma, at one or
// two warps an SMSP.
//
// Design: each warp owns 16 query rows; k and v stream through a ring of
// cp.async stages, one block-wide barrier a stage (two where the block
// splits a tile once). S = q k^T and O += p v run on the tensor cores in
// 3xTF32 (dotatt.cuh: operands split by integer RNA rounding; chains of at
// most two k-steps over the head width, or one key tile, then added in
// IEEE f32, since the tensor cores truncate their sums). The logits and the
// online max and sum stay on the accumulator fragments (the quad's
// shuffles in a fixed order); the weights p = exp(x - m) pass from the C
// fragments to the A operand of p v in registers, no shuffle and no
// barrier; O = O alpha + (the tile's p v) in one rounding. The logit's
// division by sqrt(V) is RN(s / sd) by a reciprocal and one FMA correction
// (div_rn); the epilogue divides by the sum (IEEE).
//
//   VP     rows a stage  tiles                         smem
//   16     64            split by the block, q split   36K
//   32     64            in registers                  68K
//   64     32                                          66K
//   128    32            split by each warp, q raw     99K
//   256    32            in shared memory              195K
//
// Two blocks of four warps fit on an SM up to VP 128 (up to 255 registers
// a thread). At VP 256 one block fits, so eight warps share it: two on
// each 16 rows, each reading half of every key tile (split 2, measured
// faster than four warps there). Few-block ops (cdiv(L, 64) * H * B under
// one wave of SMs, e.g. vorticity_tf lite's 32): split 4, where the four
// warps of a block own the same 16 rows and each reads a quarter of every
// key tile, four times the blocks. A split's partial (m, l, o) are combined through
// shared memory at the end, in the order of the parts (m = max, l and o
// each rescaled and summed).
//
// Each output is one fixed-order sum: two runs give the same bits. No
// float atomics, no --use_fast_math. Each entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() after
// the launch.

#include "dotatt.cuh"

namespace dotatt {

template <int VP, int SPLIT>
__global__ void __launch_bounds__(32 * FwdTiles<VP, SPLIT>::NW)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dist,
               const float* __restrict__ thr, const float* __restrict__ scale,
               float* __restrict__ out, float* __restrict__ stats, int B, int L, int H, int V,
               float sd, int vec) {
  using T = FwdTiles<VP, SPLIT>;
  constexpr int ROWS = T::ROWS, BN = T::BN, BNW = T::BNW, NT = T::NT, KS = T::KS, LD = T::LD;
  constexpr int LDR = T::LDR, RING = T::RING;
  constexpr bool PRE = T::PRE;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // ROWS x LD without OWN_REG
  float* ring = sQ + T::OWN;                      // RING x (k, v) tiles of BN x LDR
  float* big = ring + RING * T::STAGE;            // PRE: the planes of (k, v), BN x LD each
  float* small = big + T::PLANE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp / SPLIT, kp = warp % SPLIT;  // row group, key part
  const int row0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int wrow = row0 + 16 * rg;  // the warp's first row
  const int HV = H * V;
  const size_t base = (size_t)b * L * HV + (size_t)h * V;
  const bool hyb = dist != nullptr;
  const float inv = 1.f / sd;  // IEEE: RN(1 / sd)
  const int nT = cdiv(L, BN);

  auto fill = [&](int stage_, int tile) {
    float* st = ring + stage_ * T::STAGE;
    stage<BN, VP, LDR>(st, k + base, tile * BN, L, V, HV, vec);
    stage<BN, VP, LDR>(st + BN * LDR, v + base, tile * BN, L, V, HV, vec);
  };
  if constexpr (T::OWN_SM) stage<ROWS, VP, LD>(sQ, q + base, row0, L, V, HV, vec);
#pragma unroll
  for (int s = 0; s < RING - (PRE ? 0 : 1); ++s) {
    if (s < nT) fill(s, s);
    cp_commit();
  }
  Frag<4> qf[T::OWN_REG ? KS : 1];
  if constexpr (T::OWN_REG) load_a_rows_split<KS>(qf, q + base, wrow, L, V, HV, g, t);

  // rows wrow + g (r = 0) and wrow + g + 8 (r = 1)
  float sc = 0.f, tr[2];
  const float* drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + g + 8 * r;
    tr[r] = INFINITY;
    drow[r] = nullptr;
    if (hyb && i < L) {
      drow[r] = dist + (size_t)i * L;
      if (thr) tr[r] = thr[(size_t)h * L + i];
    }
  }
  if (hyb) sc = scale[h];

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[KS][4];
  zero(o);

  for (int jt = 0; jt < nT; ++jt) {
    const float *sK, *sV;  // the warp's part of the tile: planes (PRE) or ring rows
    if constexpr (PRE) {
      cp_wait<RING - 1>();
      __syncthreads();  // the tile has landed; every warp is done with the planes
      split_rows<2 * BN, VP, LD>(big, small, ring + (jt % RING) * T::STAGE);
      __syncthreads();  // the planes are ready; the ring stage is free
      if (jt + RING < nT) fill(jt % RING, jt + RING);
      cp_commit();
      sK = big + kp * BNW * LD;
    } else {
      cp_wait<RING - 2>();
      __syncthreads();  // the stage has landed; every warp is done with the one refilled next
      const int nj = jt + RING - 1;
      if (nj < nT) fill(nj % RING, nj);
      cp_commit();
      sK = ring + (jt % RING) * T::STAGE + kp * BNW * LD;
    }
    sV = sK + BN * LD;
    const int key0 = jt * BN + kp * BNW;
    auto frag_k = [&](int off) {
      if constexpr (PRE) return load_b_pl<LD>(sK + off, sK + T::PLANE + off, g, t);
      else return load_b_split<LD>(sK + off, g, t);
    };
    auto frag_v = [&](int off) {
      if constexpr (PRE) return load_b_pairs_pl<LD>(sV + off, sV + T::PLANE + off, g, t);
      else return load_b_pairs_split<LD>(sV + off, g, t);
    };

    float s[NT][4], ts[NT][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Frag<4> af;
      if constexpr (T::OWN_REG) {
        af = qf[kk];
      } else {
        float a[4];
        load_a<LD>(a, sQ + 16 * rg * LD, kk, g, t);
        af = split(a);
      }
      Frag<2> kb[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) kb[nt] = frag_k(nt * 8 * LD + kk * 8);
      add3(s, ts, kk, KS, af, kb);
    }

    // logits, then the online softmax of rows g (r 0) and g + 8 (r 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep;
        float dd;
        const int r = e >> 1;
        s[nt][e] = logit(s[nt][e], sd, inv, hyb, drow[r], key0 + nt * 8 + 2 * t + (e & 1), L, sc,
                         tr[r], keep, dd);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float mnew = fmaxf(m[r], quad_max(mx));
      const float ms = mnew == -INFINITY ? 0.f : mnew;  // no key of this warp yet
      alpha[r] = expf(m[r] - ms);                        // 0 while m is -inf
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - ms);
          rs += s[nt][e];
        }
      l[r] = l[r] * alpha[r] + quad_sum(rs);
      m[r] = mnew;
    }

    // O = O alpha + p v: the weights' C fragments as A, v's rows in C's
    // pairs; the tile's sum in a fresh accumulator
    Frag<4> pf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) pf[nt] = c_as_a(s[nt]);
    constexpr int G = KS < CG ? KS : CG;
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += G) {
      float tv[G][4];
      zero(tv);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Frag<2> vb[G];
#pragma unroll
        for (int c = 0; c < G; ++c) vb[c] = frag_v(nt * 8 * LD + (c0 + c) * 8);
        mma3(tv, pf[nt], vb);
      }
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c0 + c][e] = fmaf(o[c0 + c][e], alpha[e >> 1], tv[c][e]);
    }
  }

  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wrow + g + 8 * r;
      if (i >= L) continue;
      float* orow = out + base + (size_t)i * HV;
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 8 + 2 * t + e;
          if (col < V) orow[col] = __fdiv_rn(o[c][2 * r + e], l[r]);
        }
      if (t == 0) {
        const size_t at = ((size_t)b * H + h) * L + i;
        stats[at] = m[r];
        stats[(size_t)B * H * L + at] = l[r];
      }
    }
    return;
  }

  // split 2 or 4: each warp's partial (o, m, l) into shared memory, then
  // combined in the order of the parts
  cp_wait<0>();
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem4);  // [part][ROWS][VP]
  float* sM = sO + SPLIT * ROWS * VP;           // [part][ROWS]
  float* sL = sM + SPLIT * ROWS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 16 * rg + g + 8 * r, at = kp * ROWS + rr;
#pragma unroll
    for (int c = 0; c < KS; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) sO[at * VP + c * 8 + 2 * t + e] = o[c][2 * r + e];
    if (t == 0) {
      sM[at] = m[r];
      sL[at] = l[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ROWS * VP; idx += 32 * T::NW) {
    const int rr = idx / VP, col = idx % VP, i = row0 + rr;
    if (i >= L || col >= V) continue;
    float mm = sM[rr];  // part 0 reads key 0: finite
#pragma unroll
    for (int w = 1; w < SPLIT; ++w) mm = fmaxf(mm, sM[w * ROWS + rr]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      const float f = expf(sM[w * ROWS + rr] - mm);
      ll += sL[w * ROWS + rr] * f;
      oo += sO[(w * ROWS + rr) * VP + col] * f;
    }
    out[base + (size_t)i * HV + col] = __fdiv_rn(oo, ll);
    if (col == 0) {
      const size_t at = ((size_t)b * H + h) * L + i;
      stats[at] = mm;
      stats[(size_t)B * H * L + at] = ll;
    }
  }
}

template <int VP, int SPLIT>
cudaError_t launch_fwd(cudaStream_t st, const float* q, const float* k, const float* v,
                       const float* dist, const float* thr, const float* scale, float* out,
                       float* stats, int B, int L, int H, int V, float sd, int vec) {
  using T = FwdTiles<VP, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<VP, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(L, T::ROWS), H, B);
  fwd_kernel<VP, SPLIT><<<grid, 32 * T::NW, T::SMEM, st>>>(q, k, v, dist, thr, scale, out, stats,
                                                           B, L, H, V, sd, vec);
  return cudaGetLastError();
}

template <int VP>
cudaError_t launch_fwd(int split, cudaStream_t st, const float* q, const float* k, const float* v,
                       const float* dist, const float* thr, const float* scale, float* out,
                       float* stats, int B, int L, int H, int V, float sd, int vec) {
  constexpr int S = fwd_cfg(VP).split;  // 1 or 2 where the op fills the card
  return split == 4
             ? launch_fwd<VP, 4>(st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec)
             : launch_fwd<VP, S>(st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
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
  const int split = dotatt::split_of(L, H, B);
  switch (vp) {
    case 16: return dotatt::launch_fwd<16>(split, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 32: return dotatt::launch_fwd<32>(split, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 64: return dotatt::launch_fwd<64>(split, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 128: return dotatt::launch_fwd<128>(split, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    case 256: return dotatt::launch_fwd<256>(split, st, q, k, v, dist, thr, scale, out, stats, B, L, H, V, sd, vec);
    default: return cudaErrorInvalidValue;
  }
}

// The split entry point `entry` (0 forward, 1 dq, 2 dk/dv) takes at this
// shape: 4 for a few-block op, else 1 or 2 by the padded width vp (for the
// record).
extern "C" int dotatt_split(int L, int H, int B, int vp, int entry) {
  if (dotatt::split_of(L, H, B) == 4) return 4;
  const dotatt::Cfg c = entry == 0 ? dotatt::fwd_cfg(vp) : entry == 1 ? dotatt::dq_cfg(vp)
                                                                      : dotatt::dkv_cfg(vp);
  return c.split;
}
