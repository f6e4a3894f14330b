// Fixed-mesh position attention, forward pass and row statistics,
// hand-written for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernels of position_induced_transformer_tpu/kernels/
// posatt_pallas.py that compute the forward and its row statistics. Three
// forwards, one per schedule of the TPU kernels' `version`, run one body
// (fwd_kernel) and differ only in what a block owns; each writes the row
// statistics M and L beside its output when the caller asks (training):
// - posatt_fixed_fwd    <- _make_posatt_kernel_v3 (_posatt_fixed_raw_v3,
//   version 3): the forward of every model path; a block owns a group of up
//   to 8 heads and a tile of the batch-folded value columns;
// - posatt_fixed_fwd_v2 <- _posatt_kernel_v2 (version 2): one head and a
//   tile of the batch-folded value columns;
// - posatt_fixed_fwd_v1 <- _posatt_kernel (version 1): one head and one
//   sample, with a tile of that sample's D columns only, so that a narrow
//   D (the Burgers encoder's 2, ZSSR's 3) weights each entry once a sample
//   (the TPU kernel's schedule);
// - posatt_stats        <- _posatt_stats: M and L alone, version 3's kernel
//   with the contraction switched off, on version 3's plan, so it writes
//   the same bits of M and L as posatt_fixed_fwd at the same shape (B and D
//   included: they set the plan). No path launches it: every forward
//   writes M and L itself.
// Each forward computes, for every output row i, head h and column
// n = b*D + k of the batch-folded values:
//
//   logit[h,i,j] = -scale[h] * dist[i,j]  if dist[i,j] <= thr[i] and finite
//                = -1e38                  otherwise (finite: no inf - inf)
//   out[b, i, h*D + k] = sum_j softmax_j(logit[h,i,:]) * u[b, j, k]
//
// in the head-concat layout (B, L_out, H*D); M[h,i] = max_j logit[h,i,j]
// and L[h,i] = sum_j exp(logit[h,i,j] - M[h,i]), (H, L_out) each.
//
// What bounds the function on this card: it must read the (L_out, L_in)
// distances once and write the output once; its operations are 2*H*B*D f32
// per KEPT entry, since a masked weight is exactly 0. A global row keeps
// all L_in entries: with B*D = 512 (the Burgers processor) the f32
// CUDA-core rate bounds it; at 2-2.7 % kept (the Burgers, vorticity and
// Darcy encoders and decoders) the bytes do.
//
// The body (the pattern of posatt_fixed_bwd.cu, one plan for all the
// fixed-mesh kernels, posatt_fixed_common.cuh):
// - A block owns 32 rows, a group of heads (version 3: up to 8, ceil(H/8)
//   groups as even as can be, any head count; versions 1 and 2: one), a
//   tile of 64-column slabs of the batch-folded values (version 1: of one
//   sample's D columns; a warp per head and slab) and one split of L_in.
//   L_in is dealt to the splits in groups of 16 keys, in turn, so a masked
//   band is shared by all of them; the split count aims at 8 warps an SM
//   (the Darcy 421^2 ZSSR encoder, 256 rows by 177,241 keys at B*D = 30:
//   32 splits; its decoder, 177,241 rows: none).
// - It works in rounds of RC keys (128 up to two heads a block, 64 up to
//   four, 32 above, RC1 in a block of one warp). A round's distances arrive
//   in shared memory in one batch of 16-byte cp.async (4-byte pieces where
//   L_in is not a multiple of 4).
//   Warp ballots list, in order, the keys that some owned row keeps; the
//   list's least and largest kept distance per row give the round's max
//   logit (-scale * least for scale >= 0, -scale * largest below), each
//   listed entry gets one exp a head, and the contraction runs over the
//   list only, on 8 x 8 lane tiles, float4 reads from shared memory, the
//   next step's u rows in flight (cp.async). Ragged u rows (D not a
//   multiple of 4: the Burgers encoder's D = 2, ZSSR's 3) take 4-byte
//   pieces masked by index, with no padded copy.
// - One pass over the distances per split: the split keeps, per row and
//   head, its running max, normaliser and un-normalised accumulator,
//   rescaled within the split as the max grows. (A first scan of the
//   split's kept distances for each row's max, with no rescale, was timed
//   and was slower at every shape: PERF.md.)
// - The splits of a tile combine in a fixed order: M = max_s M_s,
//   L = sum_s L_s exp(M_s - M), out = sum_s acc_s exp(M_s - M) / L, the
//   loads of 8 splits in flight at once. Up to 8 splits form a
//   thread-block cluster (portable size) and combine over distributed
//   shared memory; above 8 each split's record goes to scratch (a split
//   that listed no key writes its M and L only) and the last block of the
//   tile to finish (a counter per tile, left zero) combines them. One
//   split writes its output straight from its registers. No float
//   atomics: two launches give the same bits.
// - Row statistics out: the combine writes M and L when the caller passes
//   pointers for them (training saves them for the backward, so no stats
//   launch is needed; every column tile writes the same bits); with null
//   pointers (serving) it writes nothing else. Each version writes them on its own plan: where
//   two versions' blocks have the same warps, rounds and splits (not a row
//   walk) they are the same bits, elsewhere they differ in the last bits.
// - Versions 1 and 2 at one 64-column slab or less (version 1 at D <= 64:
//   every phase-16 shape but vorticity's; version 2 at B*D <= 64) take one
//   of two block shapes, by the plan:
//   - Key-split warps (KW = 4): four warps share one head's slab, each
//     contracting every fourth listed key; the four accumulators are summed
//     in warp order at the end. Where the tile has more than 32 columns and
//     the blocks do not fill the card without a split (the Burgers
//     processor and decoder at version 1).
//   - The row walk (WK = 4, 16, 32 or 64 columns, one warp): where the tile
//     has 32 columns or fewer (version 1's encoders at D 2-3, version 2's
//     B*D 16-30), whose 64-column lane tiles would be mostly idle, or the
//     blocks fill the card (the ZSSR decoder and slab at version 1). Rounds
//     of WRC = 32 keys, the next round's distances in flight (two buffers):
//     lane o finds the keys row o keeps, the warp the keys some row keeps
//     (an OR of the lanes' masks), whose u rows are staged in shared memory
//     in one batch, in key order; lane o then walks row o's kept keys: the
//     round moves its running max once, each kept key adds its weight to
//     the normaliser and its weighted u row to the accumulator. The rounds'
//     32-row weights and contraction would cover every listed key for all
//     32 rows of a block of one head and one sample, where at 2 % kept a
//     key is kept by one or two of them (phase 16's random points); the
//     walk does a kept entry's work only. Its record and combine are the
//     rounds'; one split writes its rows through shared memory, whole lines
//     at a time (a lane a row would write 16 bytes of each line, which cost
//     the ZSSR decoder half its time: PERF.md).
// - A row that keeps no entry (its threshold below its least distance, or
//   all its distances +inf) has the plain version's softmax over -1e38
//   everywhere: M = -1e38, L = L_in and the mean of u over all keys, which
//   the combine computes for such a row alone (a kept list would give 0/0).
// Tensor cores are not used (TF32 would not hold parity with the f32
// oracle), there is no fast math, and ragged edges are masked by index.
//
// The functions launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() after the launch.

#include <cooperative_groups.h>

#include "posatt_fixed_common.cuh"

namespace cg = cooperative_groups;

namespace {

// keys a round in a block of one warp
constexpr int RC1 = 64;
// keys a round of a row walk (two rounds' distances in a block's buffer)
constexpr int WRC = 32;
// a row walk's blocks a SM, for the register cap
constexpr int WALK_MIN_BLOCKS = 16;

// The shape of a forward (or stats) block: HB heads by NS 64-column slabs,
// KW warps each (KW > 1: one head and one slab, whose warps share the
// contraction's keys), or (WK > 0: the row walk, one head, one warp) a
// tile of WK columns; RC local keys a round (the round's weights, HB x RC
// rows of 32, stay within 32 KB), scanned in CH chunks of a thread each. A
// lane holds RPT rows by CPT columns of the output: an 8 x 8 tile of a
// 64-column slab, or (WK) its own row by the tile's WK columns.
template <bool OUT, int HB, int NS, int WK = 0, int KW = 1>
struct FShape {
  static_assert(WK == 0 || (OUT && HB == 1 && NS == 1 && KW == 1), "a row walk: one warp");
  static_assert(KW == 1 || (OUT && HB == 1 && NS == 1 && SK % KW == 0), "key-split warps");
  static constexpr int NW = HB * NS * KW;
  static constexpr int THREADS = NW * 32;
  static constexpr int CW = WK ? WK : NS * TN;  // value columns a block
  static constexpr int RPT = WK ? 1 : 8;
  static constexpr int CPT = WK ? WK : 8;
  static constexpr int RC = NW == 1 ? RC1 : (HB <= 2 ? 128 : (HB <= 4 ? 64 : 32));
  static constexpr int CH = (RC + THREADS - 1) / THREADS;
  // a row of a round's distances, padded against bank conflicts; at least
  // 64 wide, so that the combine's lists of splits fit in their place
  static constexpr int DP = (RC > 64 ? RC : 64) + 4;
  static_assert(TM * DP >= 2 * MAX_SPLITS * TM, "the combine's lists");
  // a split's record: M and L of its rows per head, then (OUT) its
  // un-normalised accumulator HB x TM x CW
  static constexpr int REC = HB * TM * (2 + (OUT ? CW : 0));
  // the staged u rows and the weights (none in a row walk)
  static constexpr int WP = WK + 4;  // a row walk's staged u row, padded against bank conflicts
  static_assert(WK == 0 || 2 * WRC + 4 <= DP, "a row walk's two distance buffers");
  static constexpr int MAIN = WK ? WRC * WP : (OUT ? 2 * SK * CW : 0) + HB * RC * TM;
  static constexpr int PART = (KW - 1) * TM * CW;  // the key-split warps' accumulators
  static constexpr int UNI = REC > MAIN ? (REC > PART ? REC : PART) : (MAIN > PART ? MAIN : PART);
  // resident blocks a SM the register cap allows (a row walk: 16, at most
  // 128 registers a thread)
  static constexpr int MIN_BLOCKS = WK ? WALK_MIN_BLOCKS : (SM_WARPS / NW > 0 ? SM_WARPS / NW : 1);
};

// What a forward block keeps in shared memory (dynamic: above 48 KB).
template <bool OUT, int HB, int NS, int WK, int KW>
struct FSmem {
  using S = FShape<OUT, HB, NS, WK, KW>;
  // the staged u rows [2 * SK][CW] (OUT) and the weights [HB * RC][TM];
  // after the rounds, the split's record
  __align__(16) float uni[S::UNI];
  // the round's distances [owned row][slot]; in the combine, each row's
  // list of the splits that keep an entry and their factors
  __align__(16) float d[TM][S::DP];
  float othr[TM];             // the owned rows' keep thresholds
  float scl[HB];              // the group's scales
  float mrow[HB][TM];         // the max per head and row, after the rounds
  float lrow[HB][TM];         // running normaliser
  float alpha[HB][TM];        // this round's rescale of both
  float dlo[S::NW][TM];       // each warp's least kept distance per row this round
  float dhi[S::NW][TM];       // and its largest
  float lpart[S::NW][HB][TM]; // each warp's share of the round's normaliser
  int list[S::RC];            // the listed slots, in order
  int cnt[S::CH][S::NW];
  float cl[TM];               // the combine: one head's 1 / L per row
  int empty[TM];              // the combine: the row keeps no entry at all
  int nz[TM];                 // the combine: the splits that keep an entry of the row
  float colsum[OUT ? S::CW : 1];  // sum over all keys of u, for empty rows
  int coff[WK ? WK : 1];      // a row walk: column c of the tile at u0 + coff[c] + key * D
  int last;
};

// The inputs of one forward or stats launch.
struct FArgs {
  const float* dist;   // (Lo, Li)
  const float* thr;    // (Lo)
  const float* scale;  // (H)
  const float* u;      // (B, Li, D); forward only
  float* out;          // (B, Lo, H*D); forward only
  float* M;            // (H, Lo) or null
  float* L;            // (H, Lo) or null
  float* scratch;      // splits > MAX_CLUSTER: a record per (tile, split)
  int* counters;       // splits > MAX_CLUSTER: one per tile, zero before and after
  int H, Lo, Li, D;
  int n_ct;            // column tiles (stats: 1)
  int seg, seg_ct;     // the batch-folded columns in segments of seg (version 1:
                       // a sample's D; else B*D), seg_ct column tiles each
  int R;               // local keys a split (a multiple of GROUP)
  bool vec4;           // 16-byte pieces of u and out: D % 4 == 0, both aligned
  bool dvec4;          // 16-byte pieces of dist: Li % 4 == 0 and dist aligned
};

// A block: head group and column tile blockIdx.x, row tile blockIdx.y,
// split blockIdx.z of the keys (in a cluster of the tile's splits when
// there are 2 to 8). Column tile ct covers the columns [col0, cend) of
// segment ct / seg_ct (version 1: a sample; else all B*D columns). Lane
// (og, cg) = (lane / 8, lane % 8) of warp (head wh, slab) owns the rows
// og*4 + {0..3}, 16 + og*4 + {0..3} and the columns cg*4 + {0..3},
// 32 + cg*4 + {0..3} of the slab. In the weighting lane o
// weights the entries of row o. Without OUT (posatt_stats) the block runs
// the same rounds, weights and combine and contracts nothing, so it writes
// the bits of M and L that the forward writes on the same plan. A row walk
// (WK > 0) replaces the rounds: lane o streams row o's keys of the split
// and holds row o by the tile's WK columns.
template <bool OUT, int HB, int NS, int WK, int KW>
__global__ void __launch_bounds__(FShape<OUT, HB, NS, WK, KW>::THREADS,
                                  FShape<OUT, HB, NS, WK, KW>::MIN_BLOCKS)
fwd_kernel(const FArgs a) {
  using S = FShape<OUT, HB, NS, WK, KW>;
  constexpr int NW = S::NW, THREADS = S::THREADS, CW = S::CW, RC = S::RC, CH = S::CH;
  constexpr int REC = S::REC, RPT = S::RPT, CPT = S::CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FSmem<OUT, HB, NS, WK, KW>& sm = *reinterpret_cast<FSmem<OUT, HB, NS, WK, KW>*>(smem_raw);
  float* const sv = sm.uni;                             // staged u rows
  float* const sw = sm.uni + (OUT ? 2 * SK * CW : 0);  // weights [h * RC + k][row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Lo = a.Lo, Li = a.Li, D = a.D;
  const int grp = blockIdx.x / a.n_ct, ct = blockIdx.x - grp * a.n_ct;
  const int sg = ct / a.seg_ct, sc = (ct - sg * a.seg_ct) * CW;
  const int col0 = sg * a.seg + sc, cend = sg * a.seg + min(a.seg, sc + CW);
  const int o0 = blockIdx.y * TM, h0 = grp * HB;
  const int splits = gridDim.z, split = blockIdx.z;
  const int wh = warp / (NS * KW), slab = (warp / KW) % NS, ks = warp % KW;
  // this split's keys: local index t < R is key ((t / GROUP) * splits +
  // split) * GROUP + t % GROUP, below Li, so that a band of kept keys is
  // shared by all splits
  auto global = [&](int t) { return ((t / GROUP) * splits + split) * GROUP + t % GROUP; };

  for (int o = tid; o < TM; o += THREADS)  // rows past Lo keep nothing
    sm.othr[o] = o0 + o < Lo ? __ldg(a.thr + o0 + o) : -INFINITY;
  if (tid < HB) sm.scl[tid] = h0 + tid < H ? __ldg(a.scale + h0 + tid) : 0.f;  // a missing head: finite
  for (int e = tid; e < HB * TM; e += THREADS) (&sm.lrow[0][0])[e] = 0.f;
  __syncthreads();
  const float othr = sm.othr[lane];
  float sh[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) sh[h] = sm.scl[h];

  // ---- the columns this thread stages (4 of them, fixed across steps):
  // column n = b*D + k sits at b*Li*D + k of u
  constexpr int PIECES = CW / 4;           // 4-column pieces a staged row
  constexpr int RSTEP = THREADS / PIECES;  // staged rows apart for one thread
  static_assert(THREADS % PIECES == 0, "staging");
  const int c4 = (tid % PIECES) * 4;
  size_t cb[4];
  bool cok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = col0 + c4 + e;
    cok[e] = OUT && n < cend;
    const int b = cok[e] ? n / D : 0, k = cok[e] ? n - b * D : 0;
    cb[e] = (size_t)b * Li * D + k;
  }

  // start copying the u rows of the listed keys [k0, k0 + SK) into buffer
  // buf; zeros past the list (n)
  auto stage = [&](int k0, int n, int buf, int cbase) {
#pragma unroll
    for (int r = tid / PIECES; r < SK; r += RSTEP) {
      const bool ok = k0 + r < n;
      const size_t off = ok ? (size_t)global(cbase + sm.list[k0 + r]) * D : 0;
      float* dst = sv + ((size_t)buf * SK + r) * CW + c4;
      if (a.vec4) {
        cp_async16(dst, ok && cok[0] ? a.u + cb[0] + off : a.u, ok && cok[0]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + e, ok && cok[e] ? a.u + cb[e] + off : a.u, ok && cok[e]);
      }
    }
    cp_async_commit();
  };

  // start copying the owned rows' distances to the keys of local indices
  // [cbase, min(cbase + RC, R)) into sm.d, all at once, in 16-byte
  // pieces of four consecutive keys; keys past Li are zero-filled (the
  // scan never lists them)
  auto fetch = [&](int cbase) {
    const int RPC = min(RC, a.R - cbase) / 4;  // pieces a row (R: whole groups)
    for (int e = tid; e < TM * RPC; e += THREADS) {
      const int r = e / RPC, c = (e - r * RPC) * 4;
      const int i = o0 + r, j = global(cbase + c);
      const bool row_ok = i < Lo;
      const float* src = a.dist + (size_t)(row_ok ? i : 0) * Li;
      if (a.dvec4) {
        const bool ok = row_ok && j < Li;
        cp_async16(&sm.d[r][c], ok ? src + j : a.dist, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = row_ok && j + q < Li;
          cp_async4(&sm.d[r][c + q], ok ? src + j + q : a.dist, ok);
        }
      }
    }
    cp_async_commit();
  };

  // The round's scan: thread tid checks the slots tid + c * THREADS against
  // the 32 owned rows; the block lists, in order, the slots of this split's
  // keys that keep an entry. Block-uniform: returns the count.
  auto scan = [&](int cbase) -> int {
    unsigned masks[CH];
    bool any[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int slot = c * THREADS + tid;
      any[c] = false;
      if (slot < RC && cbase + slot < a.R && global(cbase + slot) < Li) {
#pragma unroll 8
        for (int r = 0; r < TM; ++r) any[c] |= kept(sm.d[r][slot], sm.othr[r]);
      }
      masks[c] = __ballot_sync(FULL, any[c]);
      if (lane == 0) sm.cnt[c][warp] = __popc(masks[c]);
    }
    __syncthreads();
    int run = 0, off[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w == warp) off[c] = run;
        run += sm.cnt[c][w];
      }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (any[c]) sm.list[off[c] + __popc(masks[c] & ((1u << lane) - 1u))] = c * THREADS + tid;
    __syncthreads();
    return run;
  };

  const int og = lane >> 3, cgp = lane & 7;
  int rows[RPT], cols[CPT];  // this lane's rows and columns, in fours
#pragma unroll
  for (int r = 0; r < RPT; ++r) rows[r] = WK ? lane : (r / 4) * 16 + og * 4 + r % 4;
#pragma unroll
  for (int c = 0; c < CPT; ++c) cols[c] = WK ? c : (c / 4) * 32 + cgp * 4 + c % 4;
  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  // rescale this lane's accumulators by the round's max change, then
  // contract over the listed keys [0, n), whose weights are in shared
  // memory and whose first step's u rows are in flight: while step s is
  // contracted, step s + 1's rows are; one block barrier a step
  auto contract = [&](int n, int cbase) {
    if constexpr (WK == 0) {  // the rounds' 8 x 8 lane tiles (a row walk has its own)
      const int steps = (n + SK - 1) / SK;
      cp_async_wait_all();
      __syncthreads();  // the weights, the rescale and the first step's rows are visible
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float al = sm.alpha[wh][rows[r]];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] *= al;
      }
      int buf = 0;
      for (int s = 0; s < steps; ++s, buf ^= 1) {
        if (s + 1 < steps) stage((s + 1) * SK, n, buf ^ 1, cbase);
#pragma unroll
        for (int q = 0; q < SK / KW; ++q) {  // key-split warps: every KW-th key
          const int kk = q * KW + ks;
          const float* wr = sw + (size_t)(wh * RC + s * SK + kk) * TM;
          const float* vr = sv + (size_t)(buf * SK + kk) * CW + slab * TN;
          float wv[8], vv[8];
          lds4(wr + og * 4, wv);
          lds4(wr + 16 + og * 4, wv + 4);
          lds4(vr + cgp * 4, vv);
          lds4(vr + 32 + cgp * 4, vv + 4);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
        }
        cp_async_wait_all();
        __syncthreads();  // step s's buffer is free, step s + 1's is visible
      }
    }
  };

  // ---- the rounds of this split (a row walk's below, then the list
  // body's): fetch, scan, max, weights, contraction (a fetch one round ahead
  // was timed for the list body and did not pay for its shared memory:
  // PERF.md). M and L take explicit roundings (__f*_rn), so that the
  // forward and the stats entry point, two instantiations of this body,
  // give the same bits.
  bool listed = false;  // block-uniform: some round listed a key
  float mh[HB];         // the running max of this lane's row per head
#pragma unroll
  for (int h = 0; h < HB; ++h) mh[h] = -INFINITY;
  if constexpr (WK > 0) {
    // ---- the row walk, in rounds of WRC keys: a round's distances arrive
    // (coalesced, into one of two buffers, the next round's in flight while
    // this one is walked); lane o finds the keys row o keeps, the warp the
    // keys some row keeps (an OR of the lanes' masks), whose u rows (the
    // tile's WK columns) are staged in shared memory in one batch, in key
    // order; then lane o walks row o's kept keys: the round moves its
    // running max once, then each kept key adds its weight to the
    // normaliser and its weighted u row to the accumulator
    constexpr int WP = S::WP, PR = WK / 4;  // a staged row's floats and 4-column pieces
    float* const su = sm.uni;                // [WRC][WP]: the staged u rows, in key order
    const float sc0 = sh[0];
    const int b0 = col0 / D, live = cend - col0;
    const float* const u0 = a.u + (size_t)b0 * Li * D;
    for (int c = tid; c < WK; c += THREADS) {
      const int n = min(col0 + c, cend - 1), b = n / D;
      sm.coff[c] = (b - b0) * Li * D + (n - b * D);
    }
    // the distances of the keys of local indices [cbase, cbase + WRC) into
    // buffer buf (columns buf * (WRC + 4) on); keys past Li are zero-filled
    // (never kept: the walk checks the key)
    auto wfetch = [&](int cbase, int buf) {
      if (cbase >= a.R) return;
      for (int e = tid; e < TM * WRC / 4; e += THREADS) {
        const int r = e / (WRC / 4), c = (e - r * (WRC / 4)) * 4;
        const int i = o0 + r, j = global(cbase + c);
        const bool row_ok = i < Lo;
        const float* src = a.dist + (size_t)(row_ok ? i : 0) * Li;
        float* dst = &sm.d[r][buf * (WRC + 4) + c];
        if (a.dvec4) {
          const bool ok = row_ok && j < Li;
          cp_async16(dst, ok ? src + j : a.dist, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = row_ok && j + q < Li;
            cp_async4(dst + q, ok ? src + j + q : a.dist, ok);
          }
        }
      }
    };
    float m = -INFINITY, l = 0.f;
    wfetch(0, 0);
    cp_async_commit();
    for (int cbase = 0, buf = 0; cbase < a.R; cbase += WRC, buf ^= 1) {
      cp_async_wait_all();
      __syncthreads();  // the round's distances (and the column offsets) are visible
      const float* const dr = &sm.d[lane][buf * (WRC + 4)];  // this lane's row of the round
      // this lane's kept keys of the round and their least and largest
      // distance; the keys some lane keeps
      unsigned mask = 0;
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int g0 = 0; g0 < WRC; g0 += GROUP) {
        const int key0 = cbase + g0 < a.R ? global(cbase + g0) : Li;
        float dq[GROUP];
#pragma unroll
        for (int q = 0; q < GROUP; q += 4) lds4(dr + g0 + q, dq + q);
#pragma unroll
        for (int q = 0; q < GROUP; ++q)
          if (key0 + q < Li && kept(dq[q], othr)) {
            mask |= 1u << (g0 + q);
            lo = fminf(lo, dq[q]);
            hi = fmaxf(hi, dq[q]);
          }
      }
      const unsigned any = __reduce_or_sync(FULL, mask);
      const int n = __popc(any);
      if ((any >> lane) & 1u) sm.list[__popc(any & ((1u << lane) - 1u))] = lane;
      __syncthreads();  // the list is visible
      // the listed keys' u rows, 16 bytes (or 4 where D % 4 != 0) a piece;
      // then the next round's distances
      for (int e = tid; e < n * PR; e += THREADS) {
        const int k = e / PR, c = (e - k * PR) * 4;
        const float* const ur = u0 + (size_t)global(cbase + sm.list[k]) * D;
        if (a.vec4) {
          cp_async16(su + k * WP + c, c < live ? ur + sm.coff[c] : a.u, c < live);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cp_async4(su + k * WP + c + q, c + q < live ? ur + sm.coff[c + q] : a.u, c + q < live);
        }
      }
      cp_async_commit();
      wfetch(cbase + WRC, buf ^ 1);
      cp_async_commit();
      if (lo <= hi) {  // the lane's row keeps a key of the round
        const float m_new = fmaxf(m, __fmul_rn(-sc0, sc0 >= 0.f ? lo : hi));
        if (m_new > m) {  // rescale (exp(-inf) = 0 while nothing was kept)
          const float al = expf(__fsub_rn(m, m_new));
          l = __fmul_rn(l, al);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[0][c] *= al;
          m = m_new;
        }
      }
      cp_async_wait_one();
      __syncthreads();  // the staged u rows are visible
      while (mask != 0) {
        const int q = __ffs(mask) - 1;
        mask &= mask - 1;
        const float p = expf(__fsub_rn(__fmul_rn(-sc0, dr[q]), m));
        l = __fadd_rn(l, p);
        const float* const ur = su + __popc(any & ((1u << q) - 1u)) * WP;
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          float v[4];
          lds4(ur + c, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][c + e] = fmaf(p, v[e], acc[0][c + e]);
        }
      }
      __syncthreads();  // the round's staged rows and list are read
    }
    mh[0] = m;
    sm.lrow[0][lane] = l;
    listed = __any_sync(FULL, m != -INFINITY);
  }
  const int nrounds = WK ? 0 : (a.R + RC - 1) / RC;
  for (int rd = 0; rd < nrounds; ++rd) {
    const int cbase = rd * RC;
    fetch(cbase);
    cp_async_wait_all();
    __syncthreads();  // the round's distances are in shared memory
    const int n = scan(cbase);
    if (n == 0) continue;
    listed = true;
    if (OUT) stage(0, n, 0, cbase);  // in flight while the weights are computed
    // the least and largest kept distance of each row among the listed
    // keys: for scale >= 0 the row's largest logit is -scale * least
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll 4
    for (int k = warp; k < n; k += NW) {
      const float d = sm.d[lane][sm.list[k]];
      if (kept(d, othr)) {
        lo = fminf(lo, d);
        hi = fmaxf(hi, d);
      }
    }
    sm.dlo[warp][lane] = lo;
    sm.dhi[warp][lane] = hi;
    __syncthreads();
    // every warp: the new max of its lane's row per head (the same in every
    // warp) and the rescale of both, which warp 0 leaves for the contraction
    // and the normaliser
    float l0 = INFINITY, h1 = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      l0 = fminf(l0, sm.dlo[w][lane]);
      h1 = fmaxf(h1, sm.dhi[w][lane]);
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      const float m_new =
          l0 <= h1 ? fmaxf(mh[h], __fmul_rn(-sh[h], sh[h] >= 0.f ? l0 : h1)) : mh[h];
      if (warp == 0) sm.alpha[h][lane] = m_new == -INFINITY ? 1.f : expf(__fsub_rn(mh[h], m_new));
      mh[h] = m_new;
    }
    // the weights of the listed keys, one exp a head per entry, zeros up to
    // whole steps, and each warp's share of the normaliser
    const int kpad = OUT ? (n + SK - 1) / SK * SK : n;
    float lacc[HB];
#pragma unroll
    for (int h = 0; h < HB; ++h) lacc[h] = 0.f;
#pragma unroll 4
    for (int k = warp; k < kpad; k += NW) {
      const bool in = k < n;
      const float d = sm.d[lane][in ? sm.list[k] : 0];
      const bool kp = in && kept(d, othr);
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const float p = kp && h0 + h < H ? expf(__fsub_rn(__fmul_rn(-sh[h], d), mh[h])) : 0.f;
        lacc[h] = __fadd_rn(lacc[h], p);
        if (OUT) sw[(size_t)(h * RC + k) * TM + lane] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < HB; ++h) sm.lpart[warp][h][lane] = lacc[h];
    if (OUT) contract(n, cbase);
    else __syncthreads();
    if (tid < HB * TM) {  // the normaliser, the warps' shares in order
      const int h = tid / TM, r = tid - h * TM;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s = __fadd_rn(s, sm.lpart[w][h][r]);
      sm.lrow[h][r] = __fmaf_rn(sm.lrow[h][r], sm.alpha[h][r], s);
    }
  }
  if (warp == 0)
#pragma unroll
    for (int h = 0; h < HB; ++h) sm.mrow[h][lane] = mh[h];
  cp_async_wait_all();
  __syncthreads();  // the max and last normaliser are written; the staging and weights are free
  if constexpr (KW > 1) {
    // the key-split warps' accumulators, summed into warp 0's in warp order
    float* const part = sm.uni;  // [KW - 1][TM][CW]
    if (ks > 0)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; c += 4)
          *reinterpret_cast<float4*>(part + ((size_t)(ks - 1) * TM + rows[r]) * CW + cols[c]) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    __syncthreads();
    if (ks == 0)
      for (int k = 0; k < KW - 1; ++k)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; c += 4) {
            float v[4];
            lds4(part + ((size_t)k * TM + rows[r]) * CW + cols[c], v);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][c + q] += v[q];
          }
    __syncthreads();  // the shared memory is free again
  }

  // Combine the records of the tile's nsrc splits for the rows [r0, r1),
  // in split order: M = max_s M_s, L = sum_s L_s f_s with
  // f_s = exp(M_s - M), out = sum_s acc_s f_s / L. A record is M and L of
  // its rows per head, then its un-normalised accumulator HB x TM x CW.
  // A row that keeps no entry at all has the plain version's softmax over
  // -1e38 everywhere: M = -1e38, L = Li and the mean of u over all keys.
  // base(s) is split s's record, ld and ld4 a load of 1 and 4 floats. All
  // the splits' M and L of a row are loaded at once; the output sums run
  // over each row's list of the splits that keep an entry (f_s != 0, the
  // same splits for every head), 8 splits' loads in flight at once.
  auto combine = [&](auto base, auto ld, auto ld4, int nsrc, int r0, int r1) {
    float* const zf = &sm.d[0][0];             // zf[k * TM + r]: the k-th listed split's f
    int* const zs = reinterpret_cast<int*>(zf + MAX_SPLITS * TM);  // and its index
    const int live = OUT ? cend - col0 : 4;  // the tile's columns (OUT)
    const int pieces = (live + 3) / 4;
    for (int h = 0; h < HB && h0 + h < H; ++h) {
      if (tid < r1 - r0) {
        const int r = r0 + tid, i = o0 + r;
        float mq[MAX_SPLITS], lq[MAX_SPLITS];
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
          const bool ok = s < nsrc;
          mq[s] = ok ? ld(base(s) + h * TM + r) : -INFINITY;
          lq[s] = ok ? ld(base(s) + HB * TM + h * TM + r) : 0.f;
        }
        float M = -INFINITY, L = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) M = fmaxf(M, mq[s]);
        const bool none = M == -INFINITY;
        int nz = 0;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
          const float f = mq[s] == -INFINITY ? 0.f : expf(__fsub_rn(mq[s], M));
          if (f != 0.f) {
            L = __fmaf_rn(lq[s], f, L);
            zf[nz * TM + r] = f;
            zs[nz * TM + r] = s;
            ++nz;
          }
        }
        if (none) {
          M = NEG;
          L = (float)Li;
        }
        sm.cl[r] = __frcp_rn(L);
        sm.empty[r] = none && i < Lo;
        sm.nz[r] = nz;
        if (a.M != nullptr && i < Lo) {
          a.M[(size_t)(h0 + h) * Lo + i] = M;
          a.L[(size_t)(h0 + h) * Lo + i] = L;
        }
      }
      if (!OUT) continue;
      __syncthreads();
      if (h == 0) {  // rows that keep no entry: the column sums of u, once
        bool any = false;
        for (int r = r0; r < r1; ++r) any |= sm.empty[r] != 0;
        if (any) {  // block-uniform
          for (int c = tid; c < live; c += THREADS) {
            const int n = col0 + c, b = n / D;
            const float* up = a.u + (size_t)b * Li * D + (n - b * D);
            float s = 0.f;
            for (int j = 0; j < Li; ++j) s += up[(size_t)j * D];
            sm.colsum[c] = s;
          }
          __syncthreads();
        }
      }
      for (int e = tid; e < (r1 - r0) * pieces; e += THREADS) {
        const int rr = e / pieces, c = (e - rr * pieces) * 4;
        const int r = r0 + rr, i = o0 + r;
        if (i >= Lo) continue;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (sm.empty[r]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = c + q < live ? sm.colsum[c + q] : 0.f;
        } else {
          const int nz = sm.nz[r];
          for (int k0 = 0; k0 < nz; k0 += 8) {
            float4 aq[8];
            float fq[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const bool ok = k0 + k < nz;
              fq[k] = ok ? zf[(k0 + k) * TM + r] : 0.f;
              aq[k] = ok ? ld4(base(zs[(k0 + k) * TM + r]) + 2 * HB * TM +
                               (size_t)(h * TM + r) * CW + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {  // in split order
              v[0] = fmaf(aq[k].x, fq[k], v[0]);
              v[1] = fmaf(aq[k].y, fq[k], v[1]);
              v[2] = fmaf(aq[k].z, fq[k], v[2]);
              v[3] = fmaf(aq[k].w, fq[k], v[3]);
            }
          }
        }
        const float il = sm.cl[r];  // 1 / L
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q >= live) break;
          const int n = col0 + c + q, b = n / D;
          a.out[((size_t)b * Lo + i) * H * D + (size_t)(h0 + h) * D + (n - b * D)] =
              __fmul_rn(v[q], il);
        }
      }
      __syncthreads();
    }
  };
  auto ld_plain = [](const float* p) { return *p; };
  auto ld4_plain = [](const float* p) { return *reinterpret_cast<const float4*>(p); };

  if (splits == 1) {
    // one split and every row keeps an entry: M, L and the output straight
    // from the block (the bits of a one-split combine: f = 1)
    const int none = __syncthreads_or(tid < TM && o0 + tid < Lo && sm.mrow[0][tid] == -INFINITY);
    if (!none) {
      for (int e = tid; e < HB * TM; e += THREADS) {
        const int h = e / TM, r = e - h * TM, i = o0 + r;
        if (a.M != nullptr && h0 + h < H && i < Lo) {
          a.M[(size_t)(h0 + h) * Lo + i] = sm.mrow[h][r];
          a.L[(size_t)(h0 + h) * Lo + i] = sm.lrow[h][r];
        }
      }
      if constexpr (WK > 0) {
        // a row walk: the normalised rows through shared memory (the staged
        // rows' place), then out with the lanes along the columns, whole
        // lines of each row (a lane a row would write 16 bytes a line)
        float* const so = sm.uni;  // [TM][WP]
        const float il = __frcp_rn(sm.lrow[0][lane]);  // 1 / L
#pragma unroll
        for (int c = 0; c < CPT; c += 4)
          *reinterpret_cast<float4*>(so + lane * S::WP + cols[c]) =
              make_float4(__fmul_rn(acc[0][c], il), __fmul_rn(acc[0][c + 1], il),
                          __fmul_rn(acc[0][c + 2], il), __fmul_rn(acc[0][c + 3], il));
        __syncthreads();
        const int live = cend - col0, pieces = a.vec4 ? live / 4 : live;
        for (int e = tid; e < TM * pieces; e += THREADS) {
          const int r = e / pieces, i = o0 + r;
          if (i >= Lo) continue;
          float* const orow = a.out + (size_t)i * H * D + (size_t)h0 * D;
          if (a.vec4) {  // four columns of one sample: 16 bytes
            const int c = (e - r * pieces) * 4, n = col0 + c, b = n / D;
            *reinterpret_cast<float4*>(orow + (size_t)b * Lo * H * D + (n - b * D)) =
                *reinterpret_cast<const float4*>(so + r * S::WP + c);
          } else {
            const int c = e - r * pieces, n = col0 + c, b = n / D;
            orow[(size_t)b * Lo * H * D + (n - b * D)] = so[r * S::WP + c];
          }
        }
      } else if (OUT && h0 + wh < H && ks == 0) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = o0 + rows[r];
          if (i >= Lo) continue;
          const float il = __frcp_rn(sm.lrow[wh][rows[r]]);  // 1 / L
          float* const orow = a.out + (size_t)i * H * D + (size_t)(h0 + wh) * D;
#pragma unroll
          for (int c = 0; c < CPT; c += 4) {
            const int n0 = col0 + slab * TN + cols[c];
            if (a.vec4 && n0 + 3 < cend) {  // four columns of one sample: 16 bytes
              const int b = n0 / D;
              *reinterpret_cast<float4*>(orow + (size_t)b * Lo * H * D + (n0 - b * D)) =
                  make_float4(__fmul_rn(acc[r][c], il), __fmul_rn(acc[r][c + 1], il),
                              __fmul_rn(acc[r][c + 2], il), __fmul_rn(acc[r][c + 3], il));
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int n = n0 + q, b = n / D;
                if (n < cend) orow[(size_t)b * Lo * H * D + (n - b * D)] = __fmul_rn(acc[r][c + q], il);
              }
            }
          }
        }
      }
      return;
    }
  }
  // the split's record: M and L per head and row, then (OUT) the
  // accumulator, which a split that listed no key leaves out (its f is 0)
  auto write_record = [&](float* rec) {
    for (int e = tid; e < HB * TM; e += THREADS) {
      rec[e] = (&sm.mrow[0][0])[e];
      rec[HB * TM + e] = (&sm.lrow[0][0])[e];
    }
    if (OUT && listed && ks == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; c += 4)
          *reinterpret_cast<float4*>(rec + 2 * HB * TM + (size_t)(wh * TM + rows[r]) * CW +
                                     slab * TN + cols[c]) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    }
  };
  if (splits > MAX_CLUSTER) {
    // more splits than a cluster holds: the records go to scratch and the
    // last block of the tile to finish combines them (a counter per tile,
    // left zero for the next launch)
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* const scr = a.scratch + tile * splits * REC;
    write_record(scr + (size_t)split * REC);
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(a.counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    combine([&](int s) { return static_cast<const float*>(scr + (size_t)s * REC); },
            [](const float* p) { return __ldcg(p); },
            [](const float* p) { return __ldcg(reinterpret_cast<const float4*>(p)); },
            splits, 0, TM);
    if (tid == 0) a.counters[tile] = 0;
    return;
  }
  float* const rec = sm.uni;  // the staging and weights are free
  write_record(rec);
  if (splits == 1) {  // a row keeps no entry: the block's own record
    __syncthreads();
    combine([&](int) { return static_cast<const float*>(rec); }, ld_plain, ld4_plain, 1, 0, TM);
    return;
  }
  // the tile's splits form one cluster: each combines a share of the rows
  // over the blocks' shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (TM + splits - 1) / splits;
  const int r0 = split * share, r1 = min(r0 + share, TM);
  combine([&](int s) { return static_cast<const float*>(cluster.map_shared_rank(rec, s)); },
          ld_plain, ld4_plain, splits, r0, r1);
  cluster.sync();  // no block leaves while another reads its record
}

template <bool OUT, int HB, int NS, int WK = 0, int KW = 1>
int launch_fwd_shape(const FArgs& a, const Plan& p, cudaStream_t s) {
  using S = FShape<OUT, HB, NS, WK, KW>;
  constexpr int smem = (int)sizeof(FSmem<OUT, HB, NS, WK, KW>);
  int rc = (int)cudaFuncSetAttribute(fwd_kernel<OUT, HB, NS, WK, KW>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const dim3 grid(p.groups * a.n_ct, p.tiles, p.splits);
  if (p.splits > 1 && p.splits <= MAX_CLUSTER) {  // the splits of a tile: one cluster
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(S::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = p.splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, fwd_kernel<OUT, HB, NS, WK, KW>, a);
    if (rc != 0) return rc;
  } else {
    fwd_kernel<OUT, HB, NS, WK, KW><<<grid, S::THREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool OUT, int HB>
int launch_fwd_slabs(const FArgs& a, const Plan& p, cudaStream_t s) {
  if constexpr (HB == 1 && OUT) {  // a row walk over a tile of 4, 16, 32 or 64 columns
    if (p.walk == 4) return launch_fwd_shape<OUT, 1, 1, 4>(a, p, s);
    if (p.walk == 16) return launch_fwd_shape<OUT, 1, 1, 16>(a, p, s);
    if (p.walk == 32) return launch_fwd_shape<OUT, 1, 1, 32>(a, p, s);
    if (p.walk == 64) return launch_fwd_shape<OUT, 1, 1, 64>(a, p, s);
    if constexpr (KEY_WARPS > 1)  // key-split warps
      if (p.kw > 1) return launch_fwd_shape<OUT, 1, 1, 0, KEY_WARPS>(a, p, s);
  }
  if constexpr (HB == 1)
    if (p.ns == 4) return launch_fwd_shape<OUT, HB, 4>(a, p, s);
  if constexpr (HB <= 2)
    if (p.ns == 2) return launch_fwd_shape<OUT, HB, 2>(a, p, s);
  return launch_fwd_shape<OUT, HB, 1>(a, p, s);
}

template <bool OUT>
int launch_fwd(const FArgs& a, const Plan& p, cudaStream_t s) {
  switch (p.hb) {
    case 1: return launch_fwd_slabs<OUT, 1>(a, p, s);
    case 2: return launch_fwd_slabs<OUT, 2>(a, p, s);
    case 3: return launch_fwd_slabs<OUT, 3>(a, p, s);
    case 4: return launch_fwd_slabs<OUT, 4>(a, p, s);
    case 5: return launch_fwd_slabs<OUT, 5>(a, p, s);
    case 6: return launch_fwd_slabs<OUT, 6>(a, p, s);
    case 7: return launch_fwd_slabs<OUT, 7>(a, p, s);
    default: return launch_fwd_slabs<OUT, 8>(a, p, s);
  }
}

// A split's record in floats, and the tiles a launch has (one counter
// each where the records go to scratch).
long long record_floats(bool out, const Plan& p) {
  return (long long)p.hb * TM * (2 + (out ? (p.walk ? p.walk : p.ns * TN) : 0));
}

long long launch_tiles_of(bool out, const Plan& p) {
  return (long long)p.groups * (out ? p.n_ct : 1) * p.tiles;
}

// version: the forward's schedule (1, 2, 3); the stats kernel takes 3
int run_fwd(bool out, int version, const float* dist, const float* thr, const float* scale,
            const float* u, float* o, float* M, float* L, float* scratch, int* counters, int H,
            int B, int Lo, int Li, int D, cudaStream_t s) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(FWD, H, B, Lo, Li, D, version);
  if (p.splits > MAX_CLUSTER && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((M == nullptr) != (L == nullptr)) return (int)cudaErrorInvalidValue;
  const int n_ct = out ? p.n_ct : 1;
  const int seg = version == 1 ? D : B * D;  // the columns a column tile is cut from
  const FArgs a{dist, thr, scale, u, o, M, L, scratch, counters,
                H, Lo, Li, D, n_ct, seg, version == 1 ? n_ct / B : n_ct, p.R,
                out && D % 4 == 0 && aligned(u) && aligned(o), Li % 4 == 0 && aligned(dist)};
  return out ? launch_fwd<true>(a, p, s) : launch_fwd<false>(a, p, s);
}

}  // namespace

// How a launch of a forward (out = 1; version 1, 2 or 3) or of posatt_stats
// (out = 0, version 3) at this shape cuts its work: *splits, the splits of
// L_in; *warps, the warps a block; *floats, the scratch of split records it
// needs (0 up to 8 splits); *tiles, the counters it needs (one int each,
// zero before the first launch and left zero by each).
extern "C" int posatt_fwd_plan(int out, int version, int H, int B, int Lo, int Li, int D,
                               long long* floats, long long* tiles, int* splits, int* warps) {
  if (bad_shape(H, B, Lo, Li, D) || version < 1 || version > 3 || (!out && version != 3))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(FWD, H, B, Lo, Li, D, version);
  const bool scr = p.splits > MAX_CLUSTER;
  *tiles = scr ? launch_tiles_of(out != 0, p) : 0;
  *floats = scr ? launch_tiles_of(out != 0, p) * p.splits * record_floats(out != 0, p) : 0;
  *splits = p.splits;
  *warps = p.hb * p.ns * p.kw;
  return 0;
}

// The three forwards: M and L may both be null (nothing but the output is
// written); scratch and counters as posatt_fwd_plan says for the version.
extern "C" int posatt_fixed_fwd(const float* dist, const float* thr, const float* scale,
                                const float* u, float* out, float* M, float* L,
                                float* scratch, int* counters,
                                int H, int B, int Lo, int Li, int D, void* stream) {
  return run_fwd(true, 3, dist, thr, scale, u, out, M, L, scratch, counters, H, B, Lo, Li, D,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_fixed_fwd_v2(const float* dist, const float* thr, const float* scale,
                                   const float* u, float* out, float* M, float* L,
                                   float* scratch, int* counters,
                                   int H, int B, int Lo, int Li, int D, void* stream) {
  return run_fwd(true, 2, dist, thr, scale, u, out, M, L, scratch, counters, H, B, Lo, Li, D,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_fixed_fwd_v1(const float* dist, const float* thr, const float* scale,
                                   const float* u, float* out, float* M, float* L,
                                   float* scratch, int* counters,
                                   int H, int B, int Lo, int Li, int D, void* stream) {
  return run_fwd(true, 1, dist, thr, scale, u, out, M, L, scratch, counters, H, B, Lo, Li, D,
                 static_cast<cudaStream_t>(stream));
}

// B and D are the forward's: they set the plan, and so the bits.
extern "C" int posatt_stats(const float* dist, const float* thr, const float* scale,
                            float* M, float* L, float* scratch, int* counters,
                            int H, int B, int Lo, int Li, int D, void* stream) {
  if (M == nullptr) return (int)cudaErrorInvalidValue;
  return run_fwd(false, 3, dist, thr, scale, nullptr, nullptr, M, L, scratch, counters, H, B,
                 Lo, Li, D, static_cast<cudaStream_t>(stream));
}
