// Dot-product attention (#14), backward, hand-written for Hopper (sm_90a),
// float32 in and out: the gradients of dotatt_fwd.cu's output (no Pallas
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
// Two C entry points, the FlashAttention-2 schedule:
//
//   dotatt_bwd_dq    dq (B, L, H*V), delta (B, H, L) and, hybrid, dscale (H,):
//                    dq_kernel (each warp owns 16 query rows of one (sample,
//                    head), computes their delta from g and out, streams k
//                    and v, and its block writes one partial of dscale),
//                    then reduce_kernel (each head's partials summed in a
//                    fixed order: the same bits every run)
//   dotatt_bwd_dkdv  dk, dv (B, L, H*V): dkv_kernel (each warp owns 16 key
//                    rows with k and v, and streams q, g and the query
//                    rows' m, l, delta and threshold; reads dq's delta, so
//                    it runs after dotatt_bwd_dq). At VP 256, where dk's
//                    and dv's fragments would take 256 registers, two
//                    passes of the kernel: dv (the logits and p . g), then
//                    dk (the logits, dp and ds . q).
//
// Every step recomputes the logits and weights from q, k and the row stats,
// as the forward rounds them (the division by l IEEE's). No float atomics:
// every output is one fixed-order sum.
//
// What bounds them on this card: four products of 2V operations per
// (sample, head, row, column) entry each (dq: q.k, g.v, ds k, and delta's
// 2V a row; dk/dv: q.k, g.v, p g, ds q), run as 3xTF32: 3 x 8V tensor-core
// operations per kept entry against 495 dense TF32 TFLOP/s (mma.sync
// reaches about 322 here: scripts/mma_tf32_ceiling.cu), against 24V (dq)
// or 28V (dk/dv) bytes per row at 3.35 TB/s. Operations bound every op of
// the variants past a few hundred tokens; the warps' latency bounds them
// in practice.
//
// Design, as the forward's (dotatt_fwd.cu): the products on the tensor
// cores in 3xTF32 from m16n8k8 fragments, short chains summed in IEEE f32;
// the logits, weights and ds on the accumulator fragments, handed to the
// next product's A operand in registers (ds . k for dq; p^T . g and
// ds^T . q for dk/dv, whose C fragments are already the transposes: a
// dk/dv warp's rows are keys); the weights p = RN(exp(x - m) / l) by the
// reciprocal of l and one FMA correction; the streamed rows through a
// cp.async ring, one block-wide barrier a stage (two where the block
// splits a tile once for all its warps).
//
//   VP    dq: rows a stage, smem              dk/dv: rows a stage, smem
//   16    32, 18K (q, g split in registers)   32, 20K (k, v split in registers)
//   32    64, 86K                             64, 89K
//   64    32, 100K                            32, 102K
//   128   32, 165K, eight warps               32, 198K, eight warps
//   256   16, 195K, eight warps               16, 196K, eight warps, two passes
//
// Up to VP 64 (dk/dv: 128) the block splits each streamed tile once into
// TF32 planes that every warp reads; above, each warp splits what it reads.
// Up to VP 64 two blocks fit on an SM (four warps each, up to 255
// registers a thread); from VP 128 one block fits, so eight warps share it
// (split 2: two on each 16 rows, each reading half of every tile), which
// measured faster than four. Few-block ops (cdiv(L, 64) * H * B under
// one wave of SMs): split 4, the four warps of a block own the same 16 rows
// and each streams a quarter of every tile. A split's partial sums (dq; dk
// and dv) are added through shared memory at the end, in the order of the
// parts.

#include "dotatt.cuh"

namespace dotatt {

template <int VP, int SPLIT>
__global__ void __launch_bounds__(32 * DqTiles<VP, SPLIT>::NW)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ g, const float* __restrict__ stats,
              const float* __restrict__ dist, const float* __restrict__ thr,
              const float* __restrict__ scale, float* __restrict__ dq,
              float* __restrict__ delta, float* __restrict__ partial, int B, int L, int H, int V,
              float sd, int vec) {
  using T = DqTiles<VP, SPLIT>;
  constexpr int ROWS = T::ROWS, BN = T::BN, BNW = T::BNW, NT = T::NT, KS = T::KS, LD = T::LD;
  constexpr int LDR = T::LDR, RING = T::RING;
  constexpr bool PRE = T::PRE;
  constexpr int NA = T::OWN_REG ? KS : 1;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // ROWS x LD each without OWN_REG
  float* sG = sQ + ROWS * LD;
  float* ring = sQ + T::OWN;                      // RING x (k, v) tiles of BN x LDR
  float* big = ring + RING * T::STAGE;            // PRE: the planes of (k, v)
  float* small = big + T::PLANE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, t = lane & 3;
  const int rg = warp / SPLIT, kp = warp % SPLIT;
  const int row0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int wrow = row0 + 16 * rg;
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
  if constexpr (T::OWN_SM) {
    stage<ROWS, VP, LD>(sQ, q + base, row0, L, V, HV, vec);
    stage<ROWS, VP, LD>(sG, g + base, row0, L, V, HV, vec);
  }
#pragma unroll
  for (int s = 0; s < RING - (PRE ? 0 : 1); ++s) {
    if (s < nT) fill(s, s);
    cp_commit();
  }
  Frag<4> qf[NA], gf[NA];
  if constexpr (T::OWN_REG) {
    load_a_rows_split<KS>(qf, q + base, wrow, L, V, HV, gi, t);
    load_a_rows_split<KS>(gf, g + base, wrow, L, V, HV, gi, t);
  }

  // rows wrow + gi (r = 0) and wrow + gi + 8 (r = 1): stats, delta, mask
  float sc = 0.f, tr[2], m[2], l[2], il[2], dl[2];
  const float* drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + gi + 8 * r;
    tr[r] = INFINITY;
    drow[r] = nullptr;
    m[r] = 0.f;
    l[r] = 1.f;
    float acc = 0.f;  // delta: this lane's columns t, t + 4, ..., then the quad's
    if (i < L) {
      const size_t at = ((size_t)b * H + h) * L + i;
      m[r] = stats[at];
      l[r] = stats[(size_t)B * H * L + at];
      if (hyb) {
        drow[r] = dist + (size_t)i * L;
        if (thr) tr[r] = thr[(size_t)h * L + i];
      }
      const float* grow = g + base + (size_t)i * HV;
      const float* orow = out + base + (size_t)i * HV;
      for (int c = t; c < V; c += 4) acc = fmaf(__ldg(grow + c), __ldg(orow + c), acc);
    }
    il[r] = 1.f / l[r];  // IEEE: RN(1 / l)
    dl[r] = quad_sum(acc);
    if (i < L && t == 0 && kp == 0) delta[((size_t)b * H + h) * L + i] = dl[r];
  }
  if (hyb) sc = scale[h];

  float acc[KS][4];
  zero(acc);
  float dsum = 0.f;  // this lane's share of sum ds * d * keep

  for (int jt = 0; jt < nT; ++jt) {
    const float *sK, *sV;  // the warp's part of the tile: planes (PRE) or ring rows
    if constexpr (PRE) {
      cp_wait<RING - 1>();
      __syncthreads();
      split_rows<2 * BN, VP, LD>(big, small, ring + (jt % RING) * T::STAGE);
      __syncthreads();
      if (jt + RING < nT) fill(jt % RING, jt + RING);
      cp_commit();
      sK = big + kp * BNW * LD;
    } else {
      cp_wait<RING - 2>();
      __syncthreads();
      const int nj = jt + RING - 1;
      if (nj < nT) fill(nj % RING, nj);
      cp_commit();
      sK = ring + (jt % RING) * T::STAGE + kp * BNW * LD;
    }
    sV = sK + BN * LD;
    const int key0 = jt * BN + kp * BNW;
    auto frag = [&](const float* p, int off) {  // q.k and g.v: rows of k and v
      if constexpr (PRE) return load_b_pl<LD>(p + off, p + T::PLANE + off, gi, t);
      else return load_b_split<LD>(p + off, gi, t);
    };
    auto frag_pairs = [&](const float* p, int off) {  // ds k: k's rows in C's pairs
      if constexpr (PRE) return load_b_pairs_pl<LD>(p + off, p + T::PLANE + off, gi, t);
      else return load_b_pairs_split<LD>(p + off, gi, t);
    };

    float s[NT][4], dp[NT][4], ts[NT][4], tp[NT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Frag<4> af, ag;
      if constexpr (T::OWN_REG) {
        af = qf[kk];
        ag = gf[kk];
      } else {
        float a[4], a2[4];
        load_a<LD>(a, sQ + 16 * rg * LD, kk, gi, t);
        load_a<LD>(a2, sG + 16 * rg * LD, kk, gi, t);
        af = split(a);
        ag = split(a2);
      }
      Frag<2> kb[NT], vb[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        kb[nt] = frag(sK, nt * 8 * LD + kk * 8);
        vb[nt] = frag(sV, nt * 8 * LD + kk * 8);
      }
      add3(s, ts, kk, KS, af, kb);
      add3(dp, tp, kk, KS, ag, vb);
    }

    // ds = p (dp - delta), into s; dscale's terms
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = wrow + gi + 8 * r, j = key0 + nt * 8 + 2 * t + (e & 1);
        bool keep;
        float dd;
        const float x = logit(s[nt][e], sd, inv, hyb, drow[r], j, L, sc, tr[r], keep, dd);
        const float p = i < L ? div_rn(expf(x - m[r]), l[r], il[r]) : 0.f;
        const float ds = p * (dp[nt][e] - dl[r]);
        if (hyb && keep && i < L) dsum = fmaf(ds, dd, dsum);
        s[nt][e] = ds;
      }

    // dq += ds k, the tile's sum in a fresh accumulator
    Frag<4> df[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) df[nt] = c_as_a(s[nt]);
    constexpr int G = KS < CG ? KS : CG;
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += G) {
      float tq[G][4];
      zero(tq);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Frag<2> kb[G];
#pragma unroll
        for (int c = 0; c < G; ++c) kb[c] = frag_pairs(sK, nt * 8 * LD + (c0 + c) * 8);
        mma3(tq, df[nt], kb);
      }
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + c][e] = __fadd_rn(acc[c0 + c][e], tq[c][e]);
    }
  }

  if (hyb) {  // the block's partial: lanes in a fixed tree, warps in order
    __shared__ float wsum[DqTiles<VP, SPLIT>::NW];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) wsum[warp] = dsum;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < T::NW; ++w) total += wsum[w];
      partial[(size_t)h * gridDim.x * B + (size_t)b * gridDim.x + blockIdx.x] = total;
    }
  }

  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wrow + gi + 8 * r;
      if (i >= L) continue;
      float* row = dq + base + (size_t)i * HV;
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 8 + 2 * t + e;
          if (col < V) row[col] = __fdiv_rn(acc[c][2 * r + e], sd);
        }
    }
    return;
  }

  // split 2 or 4: the parts' sums added in their order
  cp_wait<0>();
  __syncthreads();
  float* sA = reinterpret_cast<float*>(smem4);  // [part][ROWS][VP]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < KS; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sA[(kp * ROWS + 16 * rg + gi + 8 * r) * VP + c * 8 + 2 * t + e] = acc[c][2 * r + e];
  __syncthreads();
  for (int idx = tid; idx < ROWS * VP; idx += 32 * T::NW) {
    const int rr = idx / VP, col = idx % VP, i = row0 + rr;
    if (i >= L || col >= V) continue;
    float sum = sA[rr * VP + col];
#pragma unroll
    for (int w = 1; w < SPLIT; ++w) sum += sA[(w * ROWS + rr) * VP + col];
    dq[base + (size_t)i * HV + col] = __fdiv_rn(sum, sd);
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

// Stage the query rows' scalars [i0, i0 + BN): m, l, delta, threshold
// (zeros past L; the threshold +inf without thresholds)
template <int BN>
__device__ __forceinline__ void stage_scalars(float* sm, const float* stats, const float* delta,
                                              const float* thr, size_t srow, size_t lstride,
                                              size_t trow, int i0, int L, bool hyb) {
  const int n = (hyb && thr) ? 4 : 3;
  for (int idx = threadIdx.x; idx < n * BN; idx += blockDim.x) {
    const int which = idx / BN, r = idx % BN, i = i0 + r;
    const bool ok = i < L;
    const float* src = which == 0 ? stats + srow : which == 1 ? stats + lstride + srow
                       : which == 2 ? delta + srow : thr + trow;
    cp4(sm + which * BN + r, ok ? src + i : stats, ok);
  }
}

template <int VP, int SPLIT, bool DK, bool DV>
__global__ void __launch_bounds__(32 * DkvTiles<VP, SPLIT>::NW)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ stats, const float* __restrict__ delta,
               const float* __restrict__ dist, const float* __restrict__ thr,
               const float* __restrict__ scale, float* __restrict__ dk, float* __restrict__ dv,
               int B, int L, int H, int V, float sd, int vec) {
  using T = DkvTiles<VP, SPLIT>;
  constexpr int ROWS = T::ROWS, BN = T::BN, BNW = T::BNW, NT = T::NT, KS = T::KS, LD = T::LD;
  constexpr int LDR = T::LDR, RING = T::RING;
  constexpr bool PRE = T::PRE;
  constexpr int NA = T::OWN_REG ? KS : 1;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // ROWS x LD each without OWN_REG
  float* sVo = sK + ROWS * LD;
  float* ring = sK + T::OWN;  // RING x (q, g tiles of BN x LDR; m, l, delta, t of BN)
  float* big = ring + RING * T::STAGE;  // PRE: the planes of (q, g), then the scalars
  float* small = big + T::PLANE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, t = lane & 3;
  const int rg = warp / SPLIT, qp = warp % SPLIT;  // key-row group, query part
  const int col0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int wrow = col0 + 16 * rg;  // the warp's first key
  const int HV = H * V;
  const size_t base = (size_t)b * L * HV + (size_t)h * V;
  const size_t srow = ((size_t)b * H + h) * L, lstride = (size_t)B * H * L, trow = (size_t)h * L;
  const bool hyb = dist != nullptr;
  const float inv = 1.f / sd;  // IEEE: RN(1 / sd)
  const int nT = cdiv(L, BN);

  auto fill = [&](int stage_, int tile) {
    float* st = ring + stage_ * T::STAGE;
    stage<BN, VP, LDR>(st, q + base, tile * BN, L, V, HV, vec);
    stage<BN, VP, LDR>(st + BN * LDR, g + base, tile * BN, L, V, HV, vec);
    stage_scalars<BN>(st + 2 * BN * LDR, stats, delta, thr, srow, lstride, trow, tile * BN, L, hyb);
  };
  if constexpr (T::OWN_SM) {
    stage<ROWS, VP, LD>(sK, k + base, col0, L, V, HV, vec);
    if (DK) stage<ROWS, VP, LD>(sVo, v + base, col0, L, V, HV, vec);
  }
#pragma unroll
  for (int s = 0; s < RING - (PRE ? 0 : 1); ++s) {
    if (s < nT) fill(s, s);
    cp_commit();
  }
  Frag<4> kf[NA], vf[NA];
  if constexpr (T::OWN_REG) {
    load_a_rows_split<KS>(kf, k + base, wrow, L, V, HV, gi, t);
    if (DK) load_a_rows_split<KS>(vf, v + base, wrow, L, V, HV, gi, t);
  }
  const float sc = hyb ? scale[h] : 0.f;

  float ak[DK ? KS : 1][4], av[DV ? KS : 1][4];
  zero(ak);
  zero(av);

  for (int it = 0; it < nT; ++it) {
    const float *sQ, *sS;  // the warp's part of the tile: planes (PRE) or ring rows; scalars
    if constexpr (PRE) {
      cp_wait<RING - 1>();
      __syncthreads();
      const float* st = ring + (it % RING) * T::STAGE;
      split_rows<2 * BN, VP, LD>(big, small, st, small + T::PLANE, st + 2 * BN * LDR, 4 * BN);
      for (int r = tid; r < BN; r += 32 * T::NW)  // RN(1 / l) of each query row
        small[T::PLANE + 4 * BN + r] = 1.f / st[2 * BN * LDR + BN + r];
      __syncthreads();
      if (it + RING < nT) fill(it % RING, it + RING);
      cp_commit();
      sQ = big + qp * BNW * LD;
      sS = small + T::PLANE + qp * BNW;
    } else {
      cp_wait<RING - 2>();
      __syncthreads();
      const int ni = it + RING - 1;
      if (ni < nT) fill(ni % RING, ni);
      cp_commit();
      const float* st = ring + (it % RING) * T::STAGE;
      sQ = st + qp * BNW * LD;
      sS = st + 2 * BN * LD + qp * BNW;
    }
    const float* sG = sQ + BN * LD;
    const int q0 = it * BN + qp * BNW;
    auto frag = [&](const float* p, int off) {  // k.q and v.g: rows of q and g
      if constexpr (PRE) return load_b_pl<LD>(p + off, p + T::PLANE + off, gi, t);
      else return load_b_split<LD>(p + off, gi, t);
    };
    auto frag_pairs = [&](const float* p, int off) {  // p^T g, ds^T q: rows in C's pairs
      if constexpr (PRE) return load_b_pairs_pl<LD>(p + off, p + T::PLANE + off, gi, t);
      else return load_b_pairs_split<LD>(p + off, gi, t);
    };

    // s^T = k q^T and dp^T = v g^T: rows keys, columns queries
    float s[NT][4], dp[NT][4], ts[NT][4], tp[NT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Frag<4> ka, va;
      if constexpr (T::OWN_REG) {
        ka = kf[kk];
        if (DK) va = vf[kk];
      } else {
        float a[4], a2[4];
        load_a<LD>(a, sK + 16 * rg * LD, kk, gi, t);
        ka = split(a);
        if (DK) {
          load_a<LD>(a2, sVo + 16 * rg * LD, kk, gi, t);
          va = split(a2);
        }
      }
      Frag<2> qb[NT], gb[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        qb[nt] = frag(sQ, nt * 8 * LD + kk * 8);
        if (DK) gb[nt] = frag(sG, nt * 8 * LD + kk * 8);
      }
      add3(s, ts, kk, KS, ka, qb);
      if (DK) add3(dp, tp, kk, KS, va, gb);
    }

    // p^T into s, ds^T into dp
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = nt * 8 + 2 * t + (e & 1), i = q0 + cq;
        const int j = wrow + gi + 8 * (e >> 1);
        const float mi = sS[cq], li = sS[BN + cq];
        const float il = PRE ? sS[4 * BN + cq] : 1.f / li;
        const float ti = (hyb && thr) ? sS[3 * BN + cq] : INFINITY;
        bool keep;
        float dd;
        const float x = logit(s[nt][e], sd, inv, hyb, hyb && i < L ? dist + (size_t)i * L : nullptr,
                              j, L, sc, ti, keep, dd);
        const float p = i < L ? div_rn(expf(x - mi), li, il) : 0.f;
        s[nt][e] = p;
        if (DK) dp[nt][e] = p * (dp[nt][e] - sS[2 * BN + cq]);
      }

    // dv += p^T g, dk += ds^T q, the tile's sums in fresh accumulators
    Frag<4> pf[DV ? NT : 1], df[DK ? NT : 1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (DV) pf[DV ? nt : 0] = c_as_a(s[nt]);
      if (DK) df[DK ? nt : 0] = c_as_a(dp[nt]);
    }
    constexpr int G = KS < CG ? KS : CG;
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += G) {
      float tv[G][4], tk[G][4];
      zero(tv);
      zero(tk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Frag<2> gb[G], qb[G];
#pragma unroll
        for (int c = 0; c < G; ++c) {
          if (DV) gb[c] = frag_pairs(sG, nt * 8 * LD + (c0 + c) * 8);
          if (DK) qb[c] = frag_pairs(sQ, nt * 8 * LD + (c0 + c) * 8);
        }
        if (DV) mma3(tv, pf[DV ? nt : 0], gb);
        if (DK) mma3(tk, df[DK ? nt : 0], qb);
      }
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (DV) av[DV ? c0 + c : 0][e] = __fadd_rn(av[DV ? c0 + c : 0][e], tv[c][e]);
          if (DK) ak[DK ? c0 + c : 0][e] = __fadd_rn(ak[DK ? c0 + c : 0][e], tk[c][e]);
        }
    }
  }

  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = wrow + gi + 8 * r;
      if (j >= L) continue;
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 8 + 2 * t + e;
          if (col >= V) continue;
          if (DK) dk[base + (size_t)j * HV + col] = __fdiv_rn(ak[DK ? c : 0][2 * r + e], sd);
          if (DV) dv[base + (size_t)j * HV + col] = av[DV ? c : 0][2 * r + e];
        }
    }
    return;
  }

  // split 2 or 4: the parts' sums added in their order, dk then dv
  cp_wait<0>();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if ((pass == 0 && !DK) || (pass == 1 && !DV)) continue;
    __syncthreads();  // the tiles (or the last pass's sums) are free
    float* sA = reinterpret_cast<float*>(smem4);  // [part][ROWS][VP]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < KS; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sA[(qp * ROWS + 16 * rg + gi + 8 * r) * VP + c * 8 + 2 * t + e] =
              pass == 0 ? ak[DK ? c : 0][2 * r + e] : av[DV ? c : 0][2 * r + e];
    __syncthreads();
    for (int idx = tid; idx < ROWS * VP; idx += 32 * T::NW) {
      const int rr = idx / VP, col = idx % VP, j = col0 + rr;
      if (j >= L || col >= V) continue;
      float sum = sA[rr * VP + col];
#pragma unroll
      for (int w = 1; w < SPLIT; ++w) sum += sA[(w * ROWS + rr) * VP + col];
      if (pass == 0) dk[base + (size_t)j * HV + col] = __fdiv_rn(sum, sd);
      else dv[base + (size_t)j * HV + col] = sum;
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int VP, int SPLIT>
cudaError_t launch_dq(cudaStream_t st, const float* q, const float* k, const float* v,
                      const float* out, const float* g, const float* stats, const float* dist,
                      const float* thr, const float* scale, float* dq, float* delta,
                      float* partial, float* ds, int B, int L, int H, int V, float sd, int vec) {
  using T = DqTiles<VP, SPLIT>;
  cudaError_t err = prepare(dq_kernel<VP, SPLIT>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(L, T::ROWS), H, B);
  dq_kernel<VP, SPLIT><<<grid, 32 * T::NW, T::SMEM, st>>>(q, k, v, out, g, stats, dist, thr, scale,
                                                      dq, delta, partial, B, L, H, V, sd, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dist) return err;
  reduce_kernel<<<H, 32, 0, st>>>(partial, ds, (int)(grid.x * B));
  return cudaGetLastError();
}

template <int VP, int SPLIT, bool DK, bool DV>
cudaError_t launch_dkv_pass(cudaStream_t st, const float* q, const float* k, const float* v,
                            const float* g, const float* stats, const float* delta,
                            const float* dist, const float* thr, const float* scale, float* dk,
                            float* dv, int B, int L, int H, int V, float sd, int vec) {
  using T = DkvTiles<VP, SPLIT>;
  cudaError_t err = prepare(dkv_kernel<VP, SPLIT, DK, DV>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(L, T::ROWS), H, B);
  dkv_kernel<VP, SPLIT, DK, DV><<<grid, 32 * T::NW, T::SMEM, st>>>(
      q, k, v, g, stats, delta, dist, thr, scale, dk, dv, B, L, H, V, sd, vec);
  return cudaGetLastError();
}

template <int VP, int SPLIT>
cudaError_t launch_dkv(cudaStream_t st, const float* q, const float* k, const float* v,
                       const float* g, const float* stats, const float* delta, const float* dist,
                       const float* thr, const float* scale, float* dk, float* dv, int B, int L,
                       int H, int V, float sd, int vec) {
  if constexpr (VP < 256) {
    return launch_dkv_pass<VP, SPLIT, true, true>(st, q, k, v, g, stats, delta, dist, thr, scale,
                                                  dk, dv, B, L, H, V, sd, vec);
  } else {
    cudaError_t err = launch_dkv_pass<VP, SPLIT, false, true>(
        st, q, k, v, g, stats, delta, dist, thr, scale, dk, dv, B, L, H, V, sd, vec);
    if (err != cudaSuccess) return err;
    return launch_dkv_pass<VP, SPLIT, true, false>(st, q, k, v, g, stats, delta, dist, thr,
                                                   scale, dk, dv, B, L, H, V, sd, vec);
  }
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
// hybrid (dist not null): partial (H, ceil(L / R) * B) scratch and ds (H,),
// where R is dotatt_bwd_rows(vp).
extern "C" int dotatt_bwd_dq(const float* q, const float* k, const float* v, const float* out,
                             const float* g, const float* stats, const float* dist,
                             const float* thr, const float* scale, float* dq, float* delta,
                             float* partial, float* ds, int B, int L, int H, int V, int vp, int vec,
                             float sd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dotatt::bad_shape(B, L, H, V, vp)) return cudaErrorInvalidValue;
  const int split = dotatt::split_of(L, H, B);
#define DQ_CALL(VP)                                                                          \
  (split == 4 ? dotatt::launch_dq<VP, 4>(st, q, k, v, out, g, stats, dist, thr, scale, dq, delta, \
                                         partial, ds, B, L, H, V, sd, vec)                   \
              : dotatt::launch_dq<VP, dotatt::dq_cfg(VP).split>(st, q, k, v, out, g, stats, dist, \
                                         thr, scale, dq, delta, \
                                         partial, ds, B, L, H, V, sd, vec))
  DOTATT_VP_SWITCH(vp, DQ_CALL)
#undef DQ_CALL
}

// The fewest query rows a dq block owns (a split-4 block's), at any padded
// width vp: sizes dq's partials.
extern "C" int dotatt_bwd_rows(int vp) { return vp > 0 ? 16 : 0; }

// The dk/dv entry point: dk, dv (B, L, H*V), from dq's delta.
extern "C" int dotatt_bwd_dkdv(const float* q, const float* k, const float* v, const float* g,
                               const float* stats, const float* delta, const float* dist,
                               const float* thr, const float* scale, float* dk, float* dv, int B,
                               int L, int H, int V, int vp, int vec, float sd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dotatt::bad_shape(B, L, H, V, vp)) return cudaErrorInvalidValue;
  const int split = dotatt::split_of(L, H, B);
#define DKV_CALL(VP)                                                                          \
  (split == 4 ? dotatt::launch_dkv<VP, 4>(st, q, k, v, g, stats, delta, dist, thr, scale, dk, dv, \
                                          B, L, H, V, sd, vec)                                \
              : dotatt::launch_dkv<VP, dotatt::dkv_cfg(VP).split>(st, q, k, v, g, stats, delta, \
                                          dist, thr, scale, dk, dv, \
                                          B, L, H, V, sd, vec))
  DOTATT_VP_SWITCH(vp, DKV_CALL)
#undef DKV_CALL
}
