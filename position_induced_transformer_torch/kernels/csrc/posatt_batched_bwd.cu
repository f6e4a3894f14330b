// Per-sample-mesh position attention, backward pass, hand-written for
// Hopper (sm_90a), float32 throughout. Two C entry points that together
// replace the TPU kernel _make_bwd_kernel, launched by
// _posatt_batched_bwd_raw (pallas_call at position_induced_transformer_tpu/
// kernels/posatt_batched.py:415):
//
//   posatt_batched_bwd_dscale  -> d(loss)/d(scale) per sample, (B, H)
//   posatt_batched_bwd_du      -> d(loss)/d(values), (B, Li, D)
//
// Notation as in posatt_batched_fwd.cu: coordinates mq (B, Lo, dd) and mk
// (B, Li, dd) on the extended key axis, scale (H), values u (B, Li, D)
// shared by the H heads, the forward's output O (B, Lo, H*D) and its
// cotangent g (B, Lo, H*D), the optional band (starts, width, tile_rows),
// and the forward's row statistics stats (B, H+2, Lo): dmin, the keep
// threshold t and the reciprocal denominators rden_h. On a kept entry
// (d <= t, inside the row's window), with x = d - dmin >= 0,
//
//   P_h[i,j] = exp(-x[i,j] * scale[h]) * rden_h[i]
//
// and P is exactly 0 elsewhere. Distances are recomputed from coordinates
// in the forward's op order (__fsub_rn / __fmul_rn / __fadd_rn, no FMA
// contraction), so the kept sets are the forward's.
//
// dscale: the TPU kernel sums, per row, r = sum_j P T, v = sum_j P (-d) and
// w = sum_j P T (-d) with T = G_h U^T, and returns sum_i (w_i - r_i v_i).
// Since r_i = G_h[i] . O_h[i] (O_h[i] = sum_j P_ij U_j is the forward's
// output row), that is
//
//   ds[b,h] = sum_{i,k} G_h[i,k] * (Y_h[i,k] - v_h[i] O_h[i,k]),
//   Y_h = W_h U,  W_h = P_h (-x),  v_h[i] = sum_j W_h[i,j]
//
// with x in place of d: the two differ by dmin_i r_i (1 - sum_j P_ij), zero
// but for rounding, and the smaller x keeps the cancellation in Y - v O
// small. One pass over the kept entries gives both Y and v. Per-block
// partials are summed per (sample, head) in a fixed order by a second
// kernel: the same bits on every run, no float atomics.
//
// du: dU = sum_h P_h^T G_h, a product whose inner index runs over the
// (row i, head h) pairs. Each dU element is written by one block, with
// its sum in a fixed order.
//
// What bounds them on this card: each does 2*H*D operations per kept entry
// (plus 3*dd per distance inspected) against moving the coordinates,
// values, statistics and cotangent once. At the elasticity processor (H 2,
// D 256, every entry of the 972 x 972 window kept) the f32 CUDA-core rate
// bounds both, about 0.144 ms a launch; at the banded encoder and decoder
// (about 20 of a 384-column window kept per row) bytes do. What the design
// does (the pattern of posatt_tf_bwd.cu, the TF backward):
// - A block owns 32 "owned" indices of one sample (dscale: rows i; du: key
//   rows j) and streams over the other index (dscale: the keys of its band
//   window; du: the rows of the band tiles whose windows meet its keys,
//   every row without a band). It computes each (i, j) distance once and
//   each weight P_h[i,j] once per block, for every column it owns: a du
//   block owns all 256 columns (four warps of 64), a dscale block two
//   heads by 128 columns (a warp per head and 64-column slab).
// - Only kept work is contracted: the block first lists, in order, the
//   streamed indices that keep an entry with any of its owned indices (a
//   compaction by warp ballots in shared memory), then contracts over that
//   list. With angle-sorted clouds a 32-row tile keeps a few dozen of its
//   window's 384 columns.
// - Register tiles of 8 x 8 outputs per lane, read from shared memory as
//   float4s laid out so that a warp's loads are conflict-free: 64 FMAs per
//   four 16-byte loads (the body it replaces did 8 FMAs per 6 loads).
// - The steps are pipelined, with one block barrier each: while step s is
//   contracted, step s + 1's U (dscale) or G (du) rows are in flight
//   (cp.async, 16-byte pieces where D % 4 == 0) and the loads of its
//   coordinates and statistics are in registers; its weights are computed
//   branch-free after step s's products, in the same basic block (so that
//   the exps interleave with the FMAs), into the other of two weight
//   buffers. A du step is 16 (row, head) pairs: 16 / HB rows of HB heads.
// - No separate pass for dscale's v: each thread accumulates v for its
//   owned row over the entries it weights; the block sums those shares in
//   a fixed order.
// - Shared memory: up to 54 KB a block (dynamic: above 48 KB at eight
//   heads); blocks of up to four warps are held to 168 registers a thread
//   so that 12 warps stay resident on an SM (a cap of 128, 16 warps,
//   spills and is slower; 8 warps of 255 registers are slower too).
// PERF.md says what holds them: at the processor the products are about
// a third of the time; the staging of U or G rows, the weights and the
// per-step chain of loads, barrier and exps the rest.
// Tensor cores are not used (TF32 would not hold parity with the f32
// oracle), there is no fast math, and ragged edges are masked by index.
//
// Any head count: a dscale block owns a group of HB <= 8 heads (ceil(H/8)
// groups as even as can be; HB = H up to 8 heads), and a du block, whose
// sum runs over all heads, walks the groups in turn (above 8 heads only: up
// to 8 its code is that of one group). A short last group masks its
// missing heads.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;
constexpr int TM = 32;      // owned indices a block: rows (dscale) or keys (du)
constexpr int TK = 16;      // dscale: streamed keys a step; du: (row, head) pairs a step
constexpr int TN = 64;      // value columns a warp
constexpr int LCAP = 1024;  // the compacted list of streamed indices
constexpr int SM_WARPS = 12;  // resident warps a SM the register cap allows

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// squared distance of row coordinates q to key coordinates k, in the op
// order of ops/distances.euclidean_sq, without contraction into FMAs
__device__ __forceinline__ float sqdist(const float* q, const float* k, int dd) {
  float df = __fsub_rn(q[0], k[0]);
  float d = __fmul_rn(df, df);
#pragma unroll
  for (int c = 1; c < MAX_DIM; ++c) {
    if (c < dd) {
      df = __fsub_rn(q[c], k[c]);
      d = __fadd_rn(d, __fmul_rn(df, df));
    }
  }
  return d;
}

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// an asynchronous 4-byte copy to shared memory; zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// an asynchronous 16-byte copy to shared memory; zero-filled when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The inputs of one launch.
struct Args {
  const float* mq;      // (B, Lo, dd)
  const float* mk;      // (B, Li, dd)
  const float* scale;   // (H)
  const float* u;       // (B, Li, D); dscale only
  const float* out;     // the forward's output O (B, Lo, H*D); dscale only
  const float* g;       // (B, Lo, H*D)
  const float* stats;   // (B, H+2, Lo)
  const int* starts;    // (B, n_tiles) or null
  float* partial;       // (B, H, nparts); dscale only
  float* res;           // ds (B, H) or du (B, Li, D)
  int H, Lo, Li, D, dd, width, tile_rows, n_tiles;
  bool vec4;            // the staged rows copy in 16-byte pieces (D % 4 == 0, aligned)
};

// the window [*j_begin, *j_end) of band tile t of sample b; the whole key
// axis without a band
__device__ __forceinline__ void window(const Args& a, int b, int t, int* j_begin, int* j_end) {
  if (a.starts == nullptr) { *j_begin = 0; *j_end = a.Li; return; }
  const int s = a.starts[(size_t)b * a.n_tiles + t];
  *j_begin = max(s, 0);
  *j_end = min(s + a.width, a.Li);
}

// The shape of a block. dscale: HB heads by NS column slabs, a warp each;
// du: NS column slabs, a warp each, and HB heads a group.
template <bool DU, int HB, int NS>
struct Shape {
  static constexpr int NW = DU ? NS : HB * NS;       // warps
  static constexpr int THREADS = NW * 32;
  static constexpr int CW = NS * TN;                 // value columns a block
  // streamed indices a step: at most four a thread weights (FQ), so that
  // their loads, made a step ahead, fit in registers
  static constexpr int SK = (DU ? TK / HB : TK) < 4 * NW ? (DU ? TK / HB : TK) : 4 * NW;
  static constexpr int SR = DU ? SK * HB : SK;  // staged rows a step: U rows or G (row, head) rows
  static constexpr int WR = SK * HB;            // weight rows a step
  static constexpr int FQ = (SK + NW - 1) / NW;
  static constexpr int MIN_BLOCKS = SM_WARPS / NW > 0 ? SM_WARPS / NW : 1;
};

// What a block keeps in shared memory (dynamic: above the 48 KB of a
// static allocation at eight heads). The staged rows and the weights are
// double buffered: step s + 1's are written while step s's are used.
template <bool DU, int HB, int NS>
struct Smem {
  using S = Shape<DU, HB, NS>;
  __align__(16) float v[2][S::SR][S::CW];  // U rows (dscale) or G (row, head) rows (du)
  __align__(16) float w[2][S::WR][TM];     // dscale: W_h[h*SK + k]; du: P_h[k*HB + h]
  int list[LCAP];                          // the streamed indices that keep an entry
  float oq[TM][MAX_DIM];                   // the owned indices' coordinates
  float othr[TM];                          // dscale: the owned rows' keep thresholds
  int cnt[S::NW];
  float vpart[DU ? 1 : S::NW][HB][TM];     // dscale: each warp's share of v per head and row
  float vrow[HB][TM];                      // dscale: v per head and row
  float red[HB][NS];                       // dscale: each warp's partial
};

// A block: the owned tile blockIdx.y of sample blockIdx.z; (dscale) head
// group and column tile, (du) column tile from blockIdx.x. Lane (og, cg) =
// (lane / 8, lane % 8) of a warp owns the owned indices og*4 + {0..3} and
// 16 + og*4 + {0..3} and the columns cg*4 + {0..3} and 32 + cg*4 + {0..3}
// of the warp's 64-column slab. In the weighting, lane o weights the
// entries of owned index o.
template <bool DU, bool GROUPED, int HB, int NS>
__global__ void __launch_bounds__(Shape<DU, HB, NS>::THREADS, Shape<DU, HB, NS>::MIN_BLOCKS)
bwd_kernel(const Args a) {
  using S = Shape<DU, HB, NS>;
  constexpr int NW = S::NW, THREADS = S::THREADS, CW = S::CW, SK = S::SK, FQ = S::FQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DU, HB, NS>& sm = *reinterpret_cast<Smem<DU, HB, NS>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Lo = a.Lo, Li = a.Li, D = a.D, dd = a.dd;
  const size_t HD = (size_t)H * D;
  const int n_ct = (D + CW - 1) / CW;
  const int grp = DU ? 0 : blockIdx.x / n_ct;
  const int ct = blockIdx.x - grp * n_ct;
  const int col0 = ct * CW;
  const int o0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const float* stb = a.stats + (size_t)b * (H + 2) * Lo;
  const int wh = DU ? 0 : warp / NS;  // dscale: this warp's head in the group
  const int slab = DU ? warp : warp % NS;
  int h0 = DU ? 0 : grp * HB;  // the group's first head

  // ---- the owned indices: coordinates (and dscale's row thresholds) in
  // shared memory for the compaction, this lane's own in registers
  const int Lown = DU ? Li : Lo;
  const float* osrc = (DU ? a.mk : a.mq) + (size_t)b * Lown * dd;
  for (int e = tid; e < TM * MAX_DIM; e += THREADS) {
    const int o = e / MAX_DIM, k = e - o * MAX_DIM;
    sm.oq[o][k] = (o0 + o < Lown && k < dd) ? osrc[(size_t)(o0 + o) * dd + k] : 0.f;
  }
  if (!DU)
    for (int o = tid; o < TM; o += THREADS) sm.othr[o] = o0 + o < Lo ? stb[Lo + o0 + o] : -INFINITY;
  __syncthreads();
  const int oi = o0 + lane;  // this lane's owned index
  float oq[MAX_DIM];
#pragma unroll
  for (int k = 0; k < MAX_DIM; ++k) oq[k] = sm.oq[lane][k];
  float odmin = 0.f, orden[HB], sh[HB];
  const float othr = DU ? 0.f : sm.othr[lane];
#pragma unroll
  for (int h = 0; h < HB; ++h) orden[h] = 0.f;
  if (!DU) {
    odmin = oi < Lo ? stb[oi] : 0.f;
#pragma unroll
    for (int h = 0; h < HB; ++h)
      orden[h] = (oi < Lo && h0 + h < H) ? stb[(size_t)(2 + h0 + h) * Lo + oi] : 0.f;
  }
  auto set_scales = [&]() {  // a missing head: 0, finite
#pragma unroll
    for (int h = 0; h < HB; ++h) sh[h] = h0 + h < H ? __ldg(a.scale + h0 + h) : 0.f;
  };
  set_scales();
  const bool head_ok = DU || h0 + wh < H;  // warp-uniform

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float vacc[HB];  // dscale: this thread's share of v per head, owned row oi
#pragma unroll
  for (int h = 0; h < HB; ++h) vacc[h] = 0.f;

  // What a thread's share of a step's weighting reads from device memory,
  // loaded a step ahead so that the loads are in flight during a
  // contraction: the streamed indices k = warp + q*NW < SK of the step
  // (the same for every lane of a warp), their coordinates and (du) the
  // rows' statistics.
  struct Pending {
    float q[FQ][MAX_DIM];
    float t[FQ], mn[FQ];
    float rden[DU ? FQ : 1][HB];
    int c[FQ];  // the streamed index; -1 past the list
  };
  auto fill_load = [&](int s0, int n) {
    Pending p;
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int k = warp + q * NW;
      const bool ok = k < SK && s0 + k < n;
      const int c = ok ? sm.list[s0 + k] : 0;
      const float* src = DU ? a.mq + ((size_t)b * Lo + c) * dd : a.mk + ((size_t)b * Li + c) * dd;
#pragma unroll
      for (int m = 0; m < MAX_DIM; ++m) p.q[q][m] = m < dd ? __ldg(src + m) : 0.f;
      p.t[q] = p.mn[q] = 0.f;
      if (DU) {
        p.t[q] = __ldg(stb + Lo + c);
        p.mn[q] = __ldg(stb + c);
#pragma unroll
        for (int h = 0; h < HB; ++h)
          p.rden[DU ? q : 0][h] = h0 + h < H ? __ldg(stb + (size_t)(2 + h0 + h) * Lo + c) : 0.f;
      }
      p.c[q] = ok ? c : -1;
    }
    return p;
  };
  // the step's weights into buffer buf: one distance and one exp a head
  // per entry; [wb, we) is the window of the band tile the rows are in.
  // Branch-free (past the list, or not kept: 0), so that the compiler can
  // interleave it with the products of the step before.
  auto fill_store = [&](const Pending& p, int buf, int wb, int we) {
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int k = warp + q * NW;
      if (SK % NW != 0 && k >= SK) continue;  // warp-uniform
      const int c = p.c[q];
      const int i = DU ? c : oi, j = DU ? oi : c;
      const float d = DU ? sqdist(p.q[q], oq, dd) : sqdist(oq, p.q[q], dd);
      const bool kept = c >= 0 && i < Lo && j >= wb && j < we && d <= (DU ? p.t[q] : othr);
      const float x = kept ? __fsub_rn(d, DU ? p.mn[q] : odmin) : 0.f;
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const float e = expf(-x * sh[h]);
        const float pw = kept ? e * (DU ? p.rden[DU ? q : 0][h] : orden[h]) : 0.f;
        if (DU) {
          sm.w[buf][k * HB + h][lane] = pw;
        } else {
          const float wv = pw * -x;
          vacc[h] += wv;
          sm.w[buf][h * SK + k][lane] = wv;
        }
      }
    }
  };
  // the block: start copying step s0's U (dscale) or G (du) rows into
  // buffer buf
  auto stage = [&](int s0, int n, int buf) {
    auto row = [&](int r, bool* ok) -> const float* {
      if (DU) {
        const int ii = r / HB, h = h0 + r - ii * HB;
        *ok = s0 + ii < n && h < H;
        const int i = *ok ? sm.list[s0 + ii] : 0;
        return a.g + ((size_t)b * Lo + i) * HD + (size_t)(*ok ? h : 0) * D;
      }
      *ok = s0 + r < n;
      return a.u + ((size_t)b * Li + (*ok ? sm.list[s0 + r] : 0)) * D;
    };
    if (a.vec4) {  // CW/4 pieces of 4 columns a row
#pragma unroll
      for (int e0 = 0; e0 < S::SR * CW / 4; e0 += THREADS) {
        const int e = e0 + tid;
        if ((S::SR * CW / 4) % THREADS == 0 || e < S::SR * CW / 4) {  // predicated, no break
          const int r = e / (CW / 4), c4 = (e - r * (CW / 4)) * 4;
          bool ok;
          const float* src = row(r, &ok);
          ok = ok && col0 + c4 < D;
          cp_async16(&sm.v[buf][r][c4], ok ? src + col0 + c4 : a.g, ok);
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < S::SR * CW; e += THREADS) {
        const int r = e / CW, c = e - r * CW;
        bool ok;
        const float* src = row(r, &ok);
        ok = ok && col0 + c < D;
        cp_async4(&sm.v[buf][r][c], ok ? src + col0 + c : a.g, ok);
      }
    }
    cp_async_commit();
  };

  const int og = lane >> 3, cg = lane & 7;
  // contract over the listed streamed indices [0, n), pipelined: while step
  // s is contracted, step s + 1's rows are in flight and its weights are
  // computed; one block barrier a step. A warp of a missing head (dscale)
  // contracts zero weights.
  auto contract = [&](int n, int wb, int we) {
    if (n == 0) return;  // block-uniform
    stage(0, n, 0);
    fill_store(fill_load(0, n), 0, wb, we);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;
    for (int s0 = 0; s0 < n; s0 += SK, buf ^= 1) {
      const bool more = s0 + SK < n;  // block-uniform
      if (more) stage(s0 + SK, n, buf ^ 1);
      const Pending next = fill_load(s0 + SK, n);  // nothing past the list
#pragma unroll
      for (int kk = 0; kk < S::SR; ++kk) {
        const float* wr = sm.w[buf][DU ? kk : wh * SK + kk];
        const float* vr = &sm.v[buf][kk][slab * TN];
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
      fill_store(next, buf ^ 1, wb, we);  // past the list: zeros, never read
      cp_async_wait_all();
      __syncthreads();  // step s's buffers are free, step s + 1's are visible
    }
  };

  // Block-uniform: appends to sm.list, from *n on, the streamed indices of
  // [*c, c_end) that keep an entry with an owned index, in order, until the
  // range ends or the list has no room for another round; advances *c.
  auto compact = [&](int* c, int c_end, int wb, int we, int* n) {
    // du: the owned keys inside the window
    const int ob = DU ? max(wb - o0, 0) : 0;
    const int oe = DU ? min(min(we, Li) - o0, TM) : TM;
    while (*c < c_end && *n + THREADS <= LCAP) {
      const int cand = *c + tid;
      const bool ok = cand < c_end;
      const int cc = ok ? cand : 0;
      const float* src = DU ? a.mq + ((size_t)b * Lo + cc) * dd : a.mk + ((size_t)b * Li + cc) * dd;
      float sq[MAX_DIM];
#pragma unroll
      for (int m = 0; m < MAX_DIM; ++m) sq[m] = m < dd ? __ldg(src + m) : 0.f;
      const float t = DU ? __ldg(stb + Lo + cc) : 0.f;
      bool any = false;
      // eight owned indices at a time: their loads in flight together
      for (int o = ob; ok && o < oe && !any; o += 8) {
        float d[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = DU ? sqdist(sq, sm.oq[min(o + e, TM - 1)], dd) : sqdist(sm.oq[min(o + e, TM - 1)], sq, dd);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          any |= o + e < oe && d[e] <= (DU ? t : sm.othr[min(o + e, TM - 1)]);
      }
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (lane == 0) sm.cnt[warp] = __popc(m);
      __syncthreads();
      int off = *n, total = *n;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < warp) off += sm.cnt[w];
        total += sm.cnt[w];
      }
      if (any) sm.list[off + __popc(m & ((1u << lane) - 1u))] = cand;
      __syncthreads();  // the counts are read before the next round writes them
      *n = total;
      *c += THREADS;
    }
  };

  // ---- the streamed ranges: compact, then contract
  if (!DU) {
    int wb, we;
    window(a, b, o0 / a.tile_rows, &wb, &we);
    for (int c = wb; c < we;) {
      int n = 0;
      compact(&c, we, wb, we, &n);
      contract(n, wb, we);
    }
  } else {
    for (; h0 < (GROUPED ? H : 1); h0 += HB) {
      if (GROUPED) set_scales();
      const int n_t = a.starts != nullptr ? a.n_tiles : 1;
      for (int t = 0; t < n_t; ++t) {
        int wb, we;
        window(a, b, t, &wb, &we);
        if (max(wb, o0) >= min(we, min(o0 + TM, Li))) continue;  // no owned key in the window
        const int i_end = a.starts != nullptr ? min((t + 1) * a.tile_rows, Lo) : Lo;
        for (int c = a.starts != nullptr ? t * a.tile_rows : 0; c < i_end;) {
          int n = 0;
          compact(&c, i_end, wb, we, &n);
          contract(n, wb, we);
        }
      }
    }
  }

  // ---- epilogue
  const int rows[8] = {og * 4, og * 4 + 1, og * 4 + 2, og * 4 + 3,
                       16 + og * 4, 16 + og * 4 + 1, 16 + og * 4 + 2, 16 + og * 4 + 3};
  const int cols[8] = {cg * 4, cg * 4 + 1, cg * 4 + 2, cg * 4 + 3,
                       32 + cg * 4, 32 + cg * 4 + 1, 32 + cg * 4 + 2, 32 + cg * 4 + 3};
  const int c0 = col0 + slab * TN;  // the warp's first column
  if (DU) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = o0 + rows[r];
      if (j >= Li) continue;
      float* dst = a.res + ((size_t)b * Li + j) * D + c0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + cols[c] < D) dst[cols[c]] = acc[r][c];
    }
    return;
  }
  // dscale: v per head and row, the warps' shares summed in a fixed order;
  // then the sum over the block's (i, k) of G * (Y - v O) per head
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
  float part = 0.f;
  if (head_ok) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = o0 + rows[r];
      if (i >= Lo) continue;
      const float vi = sm.vrow[wh][rows[r]];
      const size_t base = ((size_t)b * Lo + i) * HD + (size_t)(h0 + wh) * D + c0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + cols[c] < D)
          part = fmaf(a.g[base + cols[c]], acc[r][c] - vi * a.out[base + cols[c]], part);
    }
  }
  part = warp_sum(part);
  if (lane == 0) sm.red[wh][slab] = part;
  __syncthreads();
  if (tid < HB && h0 + tid < H) {
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) s += sm.red[tid][sl];
    const size_t nparts = (size_t)gridDim.y * n_ct;
    a.partial[((size_t)b * H + h0 + tid) * nparts + (size_t)blockIdx.y * n_ct + ct] = s;
  }
}

// one warp per (sample, head); each lane sums a fixed strided set of
// partials, then a fixed butterfly: the same bits on every run
__global__ void __launch_bounds__(32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ ds, int nparts) {
  const int lane = threadIdx.x;
  const size_t bh = blockIdx.x;
  float s = 0.f;
  for (int p = lane; p < nparts; p += 32) s += partial[bh * nparts + p];
  s = warp_sum(s);
  if (lane == 0) ds[bh] = s;
}

// --------------------------------------------------------------- launch

template <bool DU, bool GROUPED, int HB, int NS>
int launch_shape(const Args& a, int B, cudaStream_t s) {
  using S = Shape<DU, HB, NS>;
  constexpr int smem = (int)sizeof(Smem<DU, HB, NS>);
  int rc = (int)cudaFuncSetAttribute(bwd_kernel<DU, GROUPED, HB, NS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int n_ct = (a.D + S::CW - 1) / S::CW;
  const int groups = DU ? 1 : (a.H + HB - 1) / HB;
  const dim3 grid(groups * n_ct, ((DU ? a.Li : a.Lo) + TM - 1) / TM, B);
  bwd_kernel<DU, GROUPED, HB, NS><<<grid, S::THREADS, smem, s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0 || DU) return rc;
  sum_partials_kernel<<<B * a.H, 32, 0, s>>>(a.partial, a.res, (int)(grid.y * n_ct));
  return (int)cudaGetLastError();
}

// dscale: a warp per head and 64-column slab, at most four a block below
// five heads (a head's slabs share its weights), one slab a head above
template <int HB>
int launch_dscale(const Args& a, int B, cudaStream_t s) {
  const int slabs = (a.D + TN - 1) / TN;
  if constexpr (HB == 1)
    if (slabs >= 3) return launch_shape<false, false, 1, 4>(a, B, s);
  if constexpr (HB <= 2)
    if (slabs >= 2) return launch_shape<false, false, HB, 2>(a, B, s);
  return launch_shape<false, false, HB, 1>(a, B, s);
}

// du: a warp per 64-column slab, up to four a block (256 columns), each
// weight computed once for all of them
template <int HB, bool GROUPED>
int launch_du(const Args& a, int B, cudaStream_t s) {
  if (a.D > 2 * TN) return launch_shape<true, GROUPED, HB, 4>(a, B, s);
  if (a.D > TN) return launch_shape<true, GROUPED, HB, 2>(a, B, s);
  return launch_shape<true, GROUPED, HB, 1>(a, B, s);
}

// heads per dscale block or per group of du steps: at most 8, in
// ceil(H/8) groups as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

bool bad_shape(int B, int H, int Lo, int Li, int D, int dd, int tile_rows, const int* starts,
               int width) {
  // a block of TM rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TM == 0);
  return B < 1 || H < 1 || Lo < 1 || Li < 1 || D < 1 || dd < 1 || dd > MAX_DIM || !tiles_ok ||
         (starts != nullptr && width < 1) || B > 65535 || (Lo + TM - 1) / TM > 65535 ||
         (Li + TM - 1) / TM > 65535;
}

// the staged rows copy in 16-byte pieces: D a multiple of 4 and the source aligned
bool vec4(const float* rows, int D) {
  return D % 4 == 0 && reinterpret_cast<size_t>(rows) % 16 == 0;
}

}  // namespace

// partial: B * H * ceil(Lo/32) * ceil(D/64) floats of scratch
extern "C" int posatt_batched_bwd_dscale(const float* mq, const float* mk, const float* scale,
                                         const float* u, const float* out, const float* g,
                                         const float* stats, const int* starts, float* partial,
                                         float* ds, int H, int B, int Lo, int Li, int D, int dd,
                                         int width, int tile_rows, void* stream) {
  if (bad_shape(B, H, Lo, Li, D, dd, tile_rows, starts, width)) return (int)cudaErrorInvalidValue;
  const Args a{mq, mk, scale, u, out, g, stats, starts, partial, ds,
               H, Lo, Li, D, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows, vec4(u, D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_group(H)) {
    case 1: return launch_dscale<1>(a, B, s);
    case 2: return launch_dscale<2>(a, B, s);
    case 3: return launch_dscale<3>(a, B, s);
    case 4: return launch_dscale<4>(a, B, s);
    case 5: return launch_dscale<5>(a, B, s);
    case 6: return launch_dscale<6>(a, B, s);
    case 7: return launch_dscale<7>(a, B, s);
    default: return launch_dscale<8>(a, B, s);
  }
}

extern "C" int posatt_batched_bwd_du(const float* mq, const float* mk, const float* scale,
                                     const float* g, const float* stats, const int* starts,
                                     float* du, int H, int B, int Lo, int Li, int D, int dd,
                                     int width, int tile_rows, void* stream) {
  if (bad_shape(B, H, Lo, Li, D, dd, tile_rows, starts, width)) return (int)cudaErrorInvalidValue;
  const Args a{mq, mk, scale, nullptr, nullptr, g, stats, starts, nullptr, du,
               H, Lo, Li, D, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows,
               vec4(g, D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {  // up to 8 heads one group holds them all
    case 1: return launch_du<1, false>(a, B, s);
    case 2: return launch_du<2, false>(a, B, s);
    case 3: return launch_du<3, false>(a, B, s);
    case 4: return launch_du<4, false>(a, B, s);
    case 5: return launch_du<5, false>(a, B, s);
    case 6: return launch_du<6, false>(a, B, s);
    case 7: return launch_du<7, false>(a, B, s);
    case 8: return launch_du<8, false>(a, B, s);
    default: break;
  }
  switch (head_group(H)) {  // 5 to 8 heads a group
    case 5: return launch_du<5, true>(a, B, s);
    case 6: return launch_du<6, true>(a, B, s);
    case 7: return launch_du<7, true>(a, B, s);
    default: return launch_du<8, true>(a, B, s);
  }
}
