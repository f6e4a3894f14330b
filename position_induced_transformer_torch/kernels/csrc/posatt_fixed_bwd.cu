// Fixed-mesh position attention, backward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Two C entry points, each the port of one
// TPU kernel of position_induced_transformer_tpu/kernels/posatt_pallas.py:
//
//   posatt_bwd_dscale  <- _posatt_bwd_dscale
//   posatt_bwd_du      <- _posatt_bwd_du
//
// and posatt_bwd_plan, which says how they split their work and how much
// scratch dscale needs. The row statistics M and L they read come from the
// forward: posatt_fixed_fwd.cu's posatt_fixed_fwd writes them when asked,
// and its posatt_stats entry point (the port of _posatt_stats) is the same
// kernel without the contraction, for the schedules that do not write
// them. posatt_fixed_common.cuh holds what the two sources share, the
// split rule among it.
//
// Notation, as in posatt_fixed_fwd.cu: dist (Lo, Li), thr (Lo), scale (H),
// values u (B, Li, D), the forward's output O and its cotangent g, both
// (B, Lo, H*D), and the batch-folded column n = b*D + k (N = B*D columns).
// An entry (i, j) is kept when dist[i,j] <= thr[i] and dist[i,j] is
// finite; on kept entries
//
//   P_h[i,j] = exp(-scale[h] * dist[i,j] - M_h[i]) / L_h[i]
//
// and P is exactly 0 elsewhere, with M, L the final softmax row max and
// normaliser of the forward's masked logits (masked logit = -1e38, finite).
//
// posatt_bwd_dscale writes d(loss)/d(scale), (H). The TPU kernel sums, per
// row, r = sum_j P T, v = sum_j P (-d), w = sum_j P T (-d) with
// T = G U^T, and returns sum_i (w_i - r_i v_i). Since r_i = G_h[i] . O_h[i]
// (O is the forward's output), that is
//
//   ds_h = sum_{i,n} G_h[i,n] * (Y_h[i,n] - v_h[i] O_h[i,n]),
//   Y_h = W_h U,  W_h = P_h (-d),  v_h[i] = sum_j W_h[i,j]
//
// Both terms are linear in the j-sums, so a block may own any set of keys
// j as well as a tile of rows and columns: its share of ds is the same
// expression over its keys. One pass over the kept entries gives Y and v;
// the two terms cancel in each block's epilogue, per (i, n). Every block
// writes one partial per head; the last block to finish (a device
// counter, left zero for the next launch) sums them in a fixed order, so
// two runs give the same bits, with no float atomics and one launch.
//
// posatt_bwd_du writes dU (B, Li, D) = sum_h P_h^T G_h: a product whose
// inner index runs over the (row i, head h) pairs. A block owns 32 keys j,
// a tile of columns and a share of the rows i. Where the rows are split,
// the blocks of one tile form a thread-block cluster (at most 8, the
// portable size): each leaves its 32 x CW partial in its shared memory and
// each sums a share of the tile's rows over the cluster's blocks in order
// (distributed shared memory), so the result is the same bits on every
// run, with no scratch, counters or second launch.
//
// What bounds them on this card: #3 and #4 do 2*H*B*D f32 operations per
// KEPT entry and must read the distances, G and U or O (or write dU) once;
// at the Burgers processor (every entry kept, B*D = 512, about 0.002 ms)
// the f32 CUDA-core rate bounds them, at the masked encoder and decoder
// the bytes do. What the design does (the pattern of posatt_batched_bwd.cu
// with the streamed index split across blocks):
// - A block owns 32 "owned" indices (dscale: rows i; du: keys j), a tile
//   of NS 64-column slabs and one split of the streamed index (dscale:
//   keys j; du: rows i). The split count aims at 8 warps an SM; the
//   streamed index is dealt to the splits in groups of 16, in turn, so
//   that the band of a masked shape is shared by all of them.
// - It works in rounds of up to RC streamed indices. A round copies the
//   distances between its indices and the owned ones into shared memory
//   at once (16-byte cp.async; du also the rows' thresholds, M and L, L
//   turned into 1 / L), lists by warp ballots, in order, the streamed
//   indices that keep an entry, computes all the listed entries' weights
//   (one exp a head per entry) into shared memory, and contracts over the
//   list only: at the masked shapes a few dozen of 1024 indices.
// - Register tiles of 8 x 8 outputs a lane, read from shared memory as
//   float4s laid out so that a warp's loads are conflict-free: 64 FMAs per
//   four 16-byte loads. The steps are pipelined with one block barrier
//   each: while step s is contracted, step s + 1's U (dscale) or G (du)
//   rows are in flight (16-byte cp.async where D % 4 == 0); the first
//   step's rows are in flight while the weights are computed.
// PERF.md says what holds them: at the Burgers shapes the products are
// about a tenth of a launch, the chain of fetch, scan, weights, barriers
// and the epilogue's reads or reduction the rest.
// Tensor cores are not used (TF32 would not hold parity with the f32
// oracle), there is no fast math, and ragged edges are masked by index,
// with no padded copy.
//
// Any head count: the dscale kernel gives a block a group of
// HB <= 8 heads (ceil(H/8) groups as even as can be, one per grid index;
// HB = H up to 8 heads), and a du block, whose sum runs over all heads,
// walks the groups in turn. A short last group masks its missing heads.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launch. dscale's counter must be
// zero before a launch and is left zero by it; two launches that run at
// the same time must not share it.

#include <cooperative_groups.h>

#include "posatt_fixed_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The shape of a block. dscale: HB heads by NS column slabs, a warp each;
// du: NS column slabs, a warp each, and HB heads a group.
template <bool DU, int HB, int NS>
struct Shape {
  static constexpr int NW = DU ? NS : HB * NS;  // warps
  static constexpr int THREADS = NW * 32;
  static constexpr int CW = NS * TN;            // value columns a block
  // streamed indices a round (RC = 32 * SCANW <= THREADS, a thread each in
  // the scan): the round's weights, HB x RC rows of 32, stay within 32 KB
  static constexpr int SCANW = NW < 8 / HB ? NW : (8 / HB > 0 ? 8 / HB : 1);
  static constexpr int RC = 32 * SCANW;
  static constexpr int SKR = DU ? (SK / HB > 0 ? SK / HB : 1) : SK;  // listed indices a step
  static constexpr int SR = DU ? SKR * HB : SK;  // staged rows a step
  static constexpr int RCP = (RC + SKR - 1) / SKR * SKR;  // the list padded to whole steps
  // the round's distances: dscale [owned row][slot], du [slot][owned key];
  // rows of whole 16-byte pieces, padded against bank conflicts
  static constexpr int DROWS = DU ? RC : TM;
  static constexpr int DP = (DU ? TM : RC) + 4;
  // the staging buffers, which du's epilogue reuses for its 32 x CW tile
  static constexpr int VROWS = 2 * SR > TM ? 2 * SR : TM;
  static constexpr int MIN_BLOCKS = SM_WARPS / NW > 0 ? SM_WARPS / NW : 1;
};

// What a block keeps in shared memory (dynamic: above 48 KB).
template <bool DU, int HB, int NS>
struct Smem {
  using S = Shape<DU, HB, NS>;
  __align__(16) float v[S::VROWS][S::CW];  // staged U rows (dscale) or G (row, head) rows (du)
  __align__(16) float w[S::RCP * HB][TM];  // dscale: W_h[h*RCP + k]; du: P_h[k*HB + h]
  __align__(16) float d[S::DROWS][S::DP];  // the round's distances, by scan slot
  __align__(16) float sthr[DU ? S::RC : 1];     // du: the round's rows' keep thresholds
  __align__(16) float mrow[DU ? HB : 1][S::RC];  // du: the round's rows' M per head
  __align__(16) float lrow[DU ? HB : 1][S::RC];  // du: the round's rows' L, then 1 / L, per head
  int list[S::RC];                         // the listed scan slots (local index - cbase), in order
  float othr[TM];                          // dscale: the owned rows' keep thresholds
  int cnt[S::NW];
  float vpart[DU ? 1 : S::NW][HB][TM];     // dscale: each warp's share of v per head and row
  float vrow[HB][TM];                      // dscale: v per head and row
  float red[HB][NS];                       // dscale: each warp's partial
  int last;                                // dscale: the block is the last to finish
};

// The inputs of one launch.
struct Args {
  const float* dist;   // (Lo, Li)
  const float* thr;    // (Lo)
  const float* scale;  // (H)
  const float* M;      // (H, Lo)
  const float* L;      // (H, Lo)
  const float* g;      // (B, Lo, H*D)
  const float* u;      // (B, Li, D); dscale only
  const float* out;    // the forward's output O (B, Lo, H*D); dscale only
  float* partial;      // dscale: (parts, H)
  int* counters;       // dscale: one launch counter
  float* res;          // ds (H) or dU (B, Li, D)
  int H, Lo, Li, D, N;
  int n_ct;            // column tiles
  int R;               // local streamed indices a split (a multiple of GROUP)
  bool vec4;           // 16-byte pieces of U, G, O: D % 4 == 0 and the arrays aligned
  bool dvec4;          // 16-byte pieces of dist: Li % 4 == 0 and dist aligned
};

// A block: the owned tile blockIdx.y; (dscale) head group and column tile,
// (du) column tile from blockIdx.x; the split blockIdx.z (du: the rank in
// a cluster of the tile's splits). Lane (og, cg) = (lane / 8, lane % 8) of
// a warp owns the owned indices og*4 + {0..3} and 16 + og*4 + {0..3} and
// the columns cg*4 + {0..3} and 32 + cg*4 + {0..3} of the warp's 64-column
// slab. In the weighting, lane o weights the entries of owned index o.
template <bool DU, int HB, int NS>
__global__ void __launch_bounds__(Shape<DU, HB, NS>::THREADS, Shape<DU, HB, NS>::MIN_BLOCKS)
bwd_kernel(const Args a) {
  using S = Shape<DU, HB, NS>;
  constexpr int NW = S::NW, THREADS = S::THREADS, CW = S::CW, SKR = S::SKR, SR = S::SR;
  constexpr int RC = S::RC, RCP = S::RCP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DU, HB, NS>& sm = *reinterpret_cast<Smem<DU, HB, NS>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Lo = a.Lo, Li = a.Li, D = a.D, N = a.N;
  const size_t HD = (size_t)H * D;
  const int grp = DU ? 0 : blockIdx.x / a.n_ct;
  const int ct = blockIdx.x - grp * a.n_ct;
  const int col0 = ct * CW;
  const int o0 = blockIdx.y * TM;
  // this split's streamed indices: local index t < R is global index
  // ((t / GROUP) * splits + split) * GROUP + t % GROUP, below len, so that
  // a band of kept indices is shared by all splits
  const int len = DU ? Lo : Li;
  auto global = [&](int t) {
    return ((t / GROUP) * (int)gridDim.z + (int)blockIdx.z) * GROUP + t % GROUP;
  };
  const int wh = DU ? 0 : warp / NS;  // dscale: this warp's head in the group
  const int slab = DU ? warp : warp % NS;
  const int oi = o0 + lane;  // the owned index this lane weights
  int h0 = DU ? 0 : grp * HB;

  // ---- per block: the owned rows' thresholds (dscale), this lane's row
  // statistics (dscale), the group's scales
  if (!DU)
    for (int o = tid; o < TM; o += THREADS) sm.othr[o] = o0 + o < Lo ? __ldg(a.thr + o0 + o) : -INFINITY;
  float sh[HB], om[HB], ol[HB], vacc[HB];  // ol: 1 / L
  auto set_heads = [&]() {  // a missing head: finite, weighs 0
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      const bool live = h0 + h < H;
      sh[h] = live ? __ldg(a.scale + h0 + h) : 0.f;
      om[h] = !DU && live && oi < Lo ? __ldg(a.M + (size_t)(h0 + h) * Lo + oi) : 0.f;
      ol[h] = !DU && live && oi < Lo ? 1.f / __ldg(a.L + (size_t)(h0 + h) * Lo + oi) : 1.f;
      vacc[h] = 0.f;
    }
  };
  set_heads();
  __syncthreads();
  const float othr = DU ? 0.f : sm.othr[lane];
  int cbase = 0;  // the first local streamed index of the current round

  // ---- the columns this thread stages (4 of them, fixed across steps):
  // the offset of column n = b*D + k in U (b*Li*D + k) or G (b*Lo*H*D + k)
  constexpr int PIECES = CW / 4;           // 4-column pieces a staged row
  constexpr int RSTEP = THREADS / PIECES;  // staged rows apart for one thread
  static_assert(THREADS % PIECES == 0, "staging");
  const int c4 = (tid % PIECES) * 4;
  size_t cb[4];
  bool cok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = col0 + c4 + e;
    cok[e] = n < N;
    const int b = cok[e] ? n / D : 0, k = cok[e] ? n - b * D : 0;
    cb[e] = DU ? (size_t)b * Lo * HD + k : (size_t)b * Li * D + k;
  }
  const float* vsrc = DU ? a.g : a.u;

  // start copying the staged rows of the step whose first listed index is
  // k0 into buffer buf; zeros past the list (n) or a missing head
  auto stage = [&](int k0, int n, int buf) {
#pragma unroll
    for (int r = tid / PIECES; r < SR; r += RSTEP) {
      bool ok;
      size_t off;
      if (DU) {
        const int kk = r / HB, h = h0 + r - kk * HB;
        ok = k0 + kk < n && h < H;
        off = ok ? (size_t)global(cbase + sm.list[k0 + kk]) * HD + (size_t)h * D : 0;
      } else {
        ok = k0 + r < n;
        off = ok ? (size_t)global(cbase + sm.list[k0 + r]) * D : 0;
      }
      float* dst = &sm.v[0][0] + ((size_t)buf * SR + r) * CW + c4;
      if (a.vec4) {
        cp_async16(dst, ok && cok[0] ? vsrc + cb[0] + off : vsrc, ok && cok[0]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + e, ok && cok[e] ? vsrc + cb[e] + off : vsrc, ok && cok[e]);
      }
    }
    cp_async_commit();
  };

  // du: start copying the round's rows' M and L of the group (h0) into
  // shared memory
  auto fetch_stats = [&]() {
    for (int e = tid; e < HB * RC; e += THREADS) {
      const int h = e / RC, slot = e - h * RC;
      const int i = global(cbase + slot);
      const bool ok = i < Lo && h0 + h < H;
      const size_t at = ok ? (size_t)(h0 + h) * Lo + i : 0;
      cp_async4(&sm.mrow[DU ? h : 0][slot], a.M + at, ok);
      cp_async4(&sm.lrow[DU ? h : 0][slot], a.L + at, ok);
    }
  };

  // Start copying the round's distances into sm.d (dscale: the owned rows'
  // distances to the keys of local indices [cbase, cbase + RC); du: those
  // rows' distances to the owned keys), all at once, in 16-byte pieces of
  // four consecutive keys; du also the rows' thresholds and the group's M
  // and L. Entries outside the ranges are zero-filled and never kept (see
  // scan).
  auto fetch = [&]() {
    constexpr int RPC = (DU ? TM : RC) / 4;  // pieces a row
    for (int e = tid; e < S::DROWS * RPC; e += THREADS) {
      const int r = e / RPC, c = (e - r * RPC) * 4;
      // dscale: row o0 + r, keys of local cbase + c ..; du: row of local
      // cbase + r, keys o0 + c ..
      const int i = DU ? global(cbase + r) : o0 + r, j = DU ? o0 + c : global(cbase + c);
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
    if (DU) {
      for (int slot = tid; slot < RC; slot += THREADS) {
        const int i = global(cbase + slot);
        cp_async4(&sm.sthr[slot], a.thr + (i < Lo ? i : 0), i < Lo);
      }
      fetch_stats();
    }
    cp_async_commit();
  };

  // du: the fetched L of the round's rows into 1 / L, each by the thread
  // that fetched it (visible after the next barrier)
  auto invert_l = [&]() {
    for (int e = tid; e < (DU ? HB * RC : 0); e += THREADS) {
      float& l = sm.lrow[DU ? e / RC : 0][e % RC];
      l = 1.f / l;
    }
  };

  // The round's scan: thread `slot` < RC checks the streamed index of local
  // index cbase + slot against the owned indices; the block lists, in
  // order, the slots that keep an entry. Block-uniform: returns the count.
  auto scan = [&]() -> int {
    cp_async_wait_all();
    __syncthreads();  // the round's distances are in shared memory
    invert_l();
    bool any = false;
    if (tid < RC && cbase + tid < a.R && global(cbase + tid) < len) {
      if (!DU) {
#pragma unroll 8
        for (int r = 0; r < TM; ++r) any |= kept(sm.d[r][tid], sm.othr[r]);
      } else {
        const float t = sm.sthr[tid];
#pragma unroll
        for (int q = 0; q < TM; q += 4) {
          float dv[4];
          lds4(&sm.d[tid][q], dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) any |= kept(dv[e], t) && o0 + q + e < Li;
        }
      }
    }
    const unsigned m = __ballot_sync(FULL, any);
    if (lane == 0) sm.cnt[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) off += sm.cnt[w];
      n += sm.cnt[w];
    }
    if (any) sm.list[off + __popc(m & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    return n;
  };

  // the weights of the listed indices [0, n), zeros up to kpad (whole
  // steps): one exp a head per entry; dscale: W = P (-d) and its row sums
  auto weigh = [&](int n, int kpad) {
#pragma unroll 4
    for (int k = warp; k < kpad; k += NW) {
      const bool in = k < n;
      const int slot = in ? sm.list[k] : 0;
      if (DU) {
        const float d = sm.d[slot][lane];
        const bool kp = in && kept(d, sm.sthr[slot]) && oi < Li;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const float p = expf(-d * sh[h] - sm.mrow[h][slot]) * sm.lrow[h][slot];
          sm.w[k * HB + h][lane] = kp && h0 + h < H ? p : 0.f;
        }
      } else {
        const float d = sm.d[lane][slot];
        const bool kp = in && kept(d, othr);
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const float p = expf(-d * sh[h] - om[h]) * ol[h];
          const float w = kp && h0 + h < H ? p * -d : 0.f;
          vacc[h] += w;
          sm.w[h * RCP + k][lane] = w;
        }
      }
    }
  };

  const int og = lane >> 3, cg = lane & 7;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // contract over the listed indices [0, n), whose weights are in shared
  // memory and whose first step's rows are in flight: while step s is
  // contracted, step s + 1's rows are; one block barrier a step
  auto contract = [&](int n) {
    const int steps = (n + SKR - 1) / SKR;
    cp_async_wait_all();
    __syncthreads();  // the weights and the first step's rows are visible
    int buf = 0;
    for (int s = 0; s < steps; ++s, buf ^= 1) {
      if (s + 1 < steps) stage((s + 1) * SKR, n, buf ^ 1);
#pragma unroll
      for (int kk = 0; kk < SR; ++kk) {
        const float* wr = sm.w[DU ? s * SR + kk : wh * RCP + s * SK + kk];
        const float* vr = &sm.v[buf * SR + kk][slab * TN];
        float wv[8], vv[8];
        lds4(wr + og * 4, wv);
        lds4(wr + 16 + og * 4, wv + 4);
        lds4(vr + cg * 4, vv);
        lds4(vr + 32 + cg * 4, vv + 4);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
      }
      cp_async_wait_all();
      __syncthreads();  // step s's buffer is free, step s + 1's is visible
    }
  };

  // ---- the rounds of this split: fetch, scan, weigh, contract
  bool listed = false;  // block-uniform: some round listed an index
  for (cbase = 0; cbase < a.R; cbase += RC) {
    fetch();
    const int n = scan();
    if (n == 0) continue;
    listed = true;
    const int kpad = (n + SKR - 1) / SKR * SKR;
    // dscale: the block's group; du: every group in turn, the first one's
    // statistics fetched with the distances
    for (int g0 = DU ? 0 : h0; g0 < (DU ? H : h0 + 1); g0 += DU ? HB : 1) {
      if (g0 != h0) {  // du, a later group: its scales and statistics
        h0 = g0;
        set_heads();
        fetch_stats();
        cp_async_commit();
        cp_async_wait_all();
        invert_l();
        __syncthreads();
      }
      stage(0, n, 0);  // in flight while the weights are computed
      weigh(n, kpad);
      contract(n);
    }
    if (DU && h0 != 0) {  // the next round fetches the first group's statistics
      h0 = 0;
      set_heads();
    }
  }

  // ---- epilogue
  const int rows[8] = {og * 4, og * 4 + 1, og * 4 + 2, og * 4 + 3,
                       16 + og * 4, 16 + og * 4 + 1, 16 + og * 4 + 2, 16 + og * 4 + 3};
  const int cols[8] = {cg * 4, cg * 4 + 1, cg * 4 + 2, cg * 4 + 3,
                       32 + cg * 4, 32 + cg * 4 + 1, 32 + cg * 4 + 2, 32 + cg * 4 + 3};

  if (DU) {
    // dU (b, j, k) for the tile's columns [col0, col0 + CW) and keys
    // [o0, o0 + 32): the block's own sum, or, over a cluster of the tile's
    // splits, each block's tile in its shared memory and block z of the
    // cluster summing its share of the rows over the blocks in order
    const int splits = gridDim.z;
    float* tile = &sm.v[0][0];  // 32 x CW, row-major
    if (splits > 1) {
      __syncthreads();  // every warp is done with the staging buffers
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; c += 4)
          *reinterpret_cast<float4*>(tile + rows[r] * CW + slab * TN + cols[c]) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (splits > 1) cluster.sync();
    // rows [r0, r1) of the tile are this block's to write
    const int share = (TM + splits - 1) / splits;
    const int r0 = splits > 1 ? (int)blockIdx.z * share : 0;
    const int r1 = splits > 1 ? min(r0 + share, TM) : TM;
    if (splits == 1) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = o0 + rows[r], n = col0 + slab * TN + cols[c];
          if (j < Li && n < N) {
            const int b = n / D;
            a.res[((size_t)b * Li + j) * D + n - b * D] = acc[r][c];
          }
        }
      return;
    }
    for (int e = r0 * (CW / 4) + tid; e < r1 * (CW / 4); e += THREADS) {
      float4 q[MAX_CLUSTER];  // every split's piece in flight at once
#pragma unroll
      for (int z = 0; z < MAX_CLUSTER; ++z)
        if (z < splits) q[z] = reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, z))[e];
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < MAX_CLUSTER; ++z) {  // in order: the same bits on every run
        if (z < splits) {
          s.x += q[z].x; s.y += q[z].y; s.z += q[z].z; s.w += q[z].w;
        }
      }
      const int r = e / (CW / 4), c = (e - r * (CW / 4)) * 4;
      const int j = o0 + r;
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = col0 + c + q;
        if (j < Li && n < N) {
          const int b = n / D;
          a.res[((size_t)b * Li + j) * D + n - b * D] = sv[q];
        }
      }
    }
    cluster.sync();  // no block leaves while another reads its tile
    return;
  }

  // dscale: v per head and row, the warps' shares summed in a fixed order;
  // then the sum over the block's (i, n) of G * (Y - v O) per head, its
  // loads issued four rows at a time
  float part = 0.f;
  if (listed) {  // block-uniform
#pragma unroll
    for (int h = 0; h < HB; ++h) sm.vpart[DU ? 0 : warp][h][lane] = vacc[h];
    __syncthreads();
    for (int e = tid; e < HB * TM; e += THREADS) {
      const int h = e / TM, o = e - h * TM;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sm.vpart[DU ? 0 : w][h][o];
      sm.vrow[h][o] = s;
    }
    __syncthreads();
    if (h0 + wh < H) {  // warp-uniform
      const int c0 = col0 + slab * TN;  // the warp's first column
      size_t ob[8];  // each column's offset in G and O
      bool nok[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = c0 + cols[c];
        nok[c] = n < N;
        const int b = nok[c] ? n / D : 0, k = nok[c] ? n - b * D : 0;
        ob[c] = (size_t)b * Lo * HD + (size_t)(h0 + wh) * D + k;
      }
#pragma unroll
      for (int r4 = 0; r4 < 8; r4 += 4) {
        float gv[4][8], ov[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = o0 + rows[r4 + r];
          const size_t ro = (size_t)min(i, Lo - 1) * HD;
          if (a.vec4) {
#pragma unroll
            for (int c = 0; c < 8; c += 4) {
              const bool ok = nok[c] && i < Lo;
              const float4 gq = ok ? __ldg(reinterpret_cast<const float4*>(a.g + ob[c] + ro)) : float4{};
              const float4 oq = ok ? __ldg(reinterpret_cast<const float4*>(a.out + ob[c] + ro)) : float4{};
              gv[r][c] = gq.x; gv[r][c + 1] = gq.y; gv[r][c + 2] = gq.z; gv[r][c + 3] = gq.w;
              ov[r][c] = oq.x; ov[r][c + 1] = oq.y; ov[r][c + 2] = oq.z; ov[r][c + 3] = oq.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const bool ok = nok[c] && i < Lo;
              gv[r][c] = ok ? __ldg(a.g + ob[c] + ro) : 0.f;
              ov[r][c] = ok ? __ldg(a.out + ob[c] + ro) : 0.f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float vi = sm.vrow[wh][rows[r4 + r]];
#pragma unroll
          for (int c = 0; c < 8; ++c) part = fmaf(gv[r][c], acc[r4 + r][c] - vi * ov[r][c], part);
        }
      }
    }
  }
  part = warp_sum(part);
  if (lane == 0) sm.red[wh][slab] = part;
  __syncthreads();
  const int parts = gridDim.y * gridDim.z * a.n_ct;
  const int pidx = (blockIdx.z * gridDim.y + blockIdx.y) * a.n_ct + ct;
  if (tid < HB && h0 + tid < H) {
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) s += sm.red[tid][sl];
    a.partial[(size_t)pidx * H + h0 + tid] = s;
  }
  // the last block to finish sums the partials: a warp per head, each lane
  // a fixed strided set, then a fixed butterfly
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sm.last = atomicAdd(a.counters, 1) == (int)(gridDim.x * gridDim.y * gridDim.z) - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  for (int h = warp; h < H; h += NW) {
    float s = 0.f;
    for (int p = lane; p < parts; p += 32) s += __ldcg(a.partial + (size_t)p * H + h);
    s = warp_sum(s);
    if (lane == 0) a.res[h] = s;
  }
  if (tid == 0) a.counters[0] = 0;
}

// --------------------------------------------------------------- launch

template <bool DU, int HB, int NS>
int launch_shape(const Args& a, const Plan& p, cudaStream_t s) {
  using S = Shape<DU, HB, NS>;
  constexpr int smem = (int)sizeof(Smem<DU, HB, NS>);
  int rc = (int)cudaFuncSetAttribute(bwd_kernel<DU, HB, NS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const dim3 grid(p.groups * p.n_ct, p.tiles, p.splits);
  if (DU && p.splits > 1) {  // the splits of a tile: one cluster
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
    rc = (int)cudaLaunchKernelEx(&cfg, bwd_kernel<DU, HB, NS>, a);
    if (rc != 0) return rc;
  } else {
    bwd_kernel<DU, HB, NS><<<grid, S::THREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool DU, int HB>
int launch_slabs(const Args& a, const Plan& p, cudaStream_t s) {
  if constexpr (DU || HB == 1)
    if (p.ns == 4) return launch_shape<DU, HB, 4>(a, p, s);
  if constexpr (DU || HB <= 2)
    if (p.ns == 2) return launch_shape<DU, HB, 2>(a, p, s);
  return launch_shape<DU, HB, 1>(a, p, s);
}

template <bool DU>
int launch(const Args& a, const Plan& p, cudaStream_t s) {
  switch (p.hb) {
    case 1: return launch_slabs<DU, 1>(a, p, s);
    case 2: return launch_slabs<DU, 2>(a, p, s);
    case 3: return launch_slabs<DU, 3>(a, p, s);
    case 4: return launch_slabs<DU, 4>(a, p, s);
    case 5: return launch_slabs<DU, 5>(a, p, s);
    case 6: return launch_slabs<DU, 6>(a, p, s);
    case 7: return launch_slabs<DU, 7>(a, p, s);
    default: return launch_slabs<DU, 8>(a, p, s);
  }
}

}  // namespace

// How a launch of posatt_bwd_dscale (du = 0) or posatt_bwd_du (du = 1)
// cuts its work: *splits, the number of splits of its streamed index, and
// *floats, the partials dscale needs (its other scratch is one int counter,
// zero before the first launch and left zero by each); du needs none.
extern "C" int posatt_bwd_plan(int du, int H, int B, int Lo, int Li, int D,
                               long long* floats, int* splits) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(du ? DU : DSCALE, H, B, Lo, Li, D);
  *floats = du ? 0 : (long long)p.n_ct * p.tiles * p.splits * H;
  *splits = p.splits;
  return 0;
}

extern "C" int posatt_bwd_dscale(const float* dist, const float* thr, const float* scale,
                                 const float* M, const float* L, const float* g,
                                 const float* u, const float* out, float* partial,
                                 int* counters, float* ds, int H, int B, int Lo, int Li, int D,
                                 void* stream) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(DSCALE, H, B, Lo, Li, D);
  const bool v4 = D % 4 == 0 && aligned(u) && aligned(g) && aligned(out);
  const Args a{dist, thr, scale, M, L, g, u, out, partial, counters, ds,
               H, Lo, Li, D, B * D, p.n_ct, p.R, v4, Li % 4 == 0 && aligned(dist)};
  return launch<false>(a, p, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_bwd_du(const float* dist, const float* thr, const float* scale,
                             const float* M, const float* L, const float* g, float* du,
                             int H, int B, int Lo, int Li, int D, void* stream) {
  if (bad_shape(H, B, Lo, Li, D)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(DU, H, B, Lo, Li, D);
  const bool v4 = D % 4 == 0 && aligned(g);
  const Args a{dist, thr, scale, M, L, g, nullptr, nullptr, nullptr, nullptr, du,
               H, Lo, Li, D, B * D, p.n_ct, p.R, v4, Li % 4 == 0 && aligned(dist)};
  return launch<true>(a, p, static_cast<cudaStream_t>(stream));
}
