// TF-semantics position attention, backward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Four C entry points, two per TPU kernel:
//
//   posatt_tf_bwd_dscale, posatt_tf_bwd_dv
//       replace _make_tf_bwd_kernel, launched by _posatt_tf_bwd_raw
//       (pallas_call at position_induced_transformer_tpu/kernels/
//       posatt_batched.py:779): pre-built distances dist (B, Lo, Li);
//   posatt_tf_coord_bwd_dscale, posatt_tf_coord_bwd_dv
//       replace _make_tf_coord_bwd_kernel, launched by
//       _posatt_tf_coord_bwd_raw (pallas_call at :1236): distances from
//       coordinates mq (B, Lo, dd) and mk (B, Li, dd) on the extended key
//       axis, with an optional band (starts, width, tile_rows).
//
// dscale -> d(loss)/d(scale) per sample and head, (B, H); dv ->
// d(loss)/d(values), (B, Li, H*V), on the extended key axis for the
// coordinate kernel (the caller's concat routes the wrap margin's share
// back). Notation as in posatt_tf_fwd.cu, plus the forward's output O and
// its cotangent G (B, Lo, H*V), and the forward's row statistics stats
// (B, H+2, Lo): dmin, the keep threshold t and the reciprocal denominators
// rden_h. On a kept entry (j in the row's window, d <= t), with
// x = d - dmin >= 0,
//
//   P_h[i,j] = exp(-x[i,j] * scale[h]) * rden_h[i]
//
// and P is exactly 0 elsewhere. Distances are recomputed in the forward's
// op order without FMA contraction, so the kept sets are the forward's.
//
// dscale: the TPU kernel sums, per row, r = sum_j P T, v = sum_j P (-d)
// and w = sum_j P T (-d) with T = G_h V_h^T, and returns
// sum_i (w_i - r_i v_i). Since r_i = G_i . O_i (O_i = sum_j P_ij V_j is
// the forward's output row), that is
//
//   ds[b,h] = sum_{i,k} G_h[i,k] * (Y_h[i,k] - v_i O_h[i,k]),
//   Y_h = W_h V_h,  W_h = P_h (-x),  v_i = sum_j W_h[i,j]
//
// with x in place of d: the two differ by dmin_i r_i (1 - sum_j P_ij),
// zero but for rounding, and the smaller x keeps the cancellation in
// Y - v O small. One pass over the kept entries gives both Y and v: no
// separate pass for v. Per-block partials are summed per (sample, head)
// in a fixed order by a second kernel: the same bits on every run, no
// float atomics.
//
// dv: dV_h = P_h^T G_h. Each dv element is written by one block.
//
// Both are one contraction over the kept entries, 2*V operations per kept
// entry and head, with the roles of rows and keys swapped: a block owns 32
// "owned" indices (dscale: rows i; dv: keys j) of one sample, a group of HG
// heads (a warp each) and 64 value columns of each, and streams over the
// other index (dscale: the keys of its band window; dv: the rows of the
// band tiles whose windows meet its keys, every row without a band).
//
// What bounds them on this card: 2*H*V operations per kept entry (plus 3*dd
// per distance inspected) against moving the coordinates (or distances),
// values, output, statistics and cotangent once. At the elasticity_tf
// processor (every entry of a 972 x 972 window kept, H*V = 512) the f32
// CUDA-core rate bounds both; at the banded encoder and decoder (about 20
// of a 384-column window kept per row) bytes do. What the design does:
// - The kept set d <= t does not depend on the head: a block computes each
//   (i, j) distance once for its heads, and each warp computes its head's
//   weight once per kept entry.
// - Only kept work is contracted: the block first lists, in order, the
//   streamed indices that keep an entry with any of its owned indices
//   (a compaction by warp ballots in shared memory), then contracts over
//   that list in steps of 16, gathering the V or G rows it names. With
//   angle-sorted clouds a 32-row tile keeps a few dozen of its window's 384
//   columns.
// - Register tiles of 8 x 8 outputs per lane, read from shared memory as
//   float4s laid out so that a warp's loads are conflict-free: 64 FMAs per
//   four 16-byte loads.
// - The steps are pipelined, with one block barrier each: while step s is
//   weighted and contracted, step s + 1's V or G rows are in flight
//   (cp.async, 16-byte pieces where V % 4 == 0) and the loads of its x tile
//   are in registers; the tile is computed after step s's products.
// - The compaction tests eight owned indices at a time, so that their
//   loads are in flight together.
// - Row statistics and owned coordinates are staged once per block in
//   shared memory.
// PERF.md says what holds them: the per-step chain of tile loads, barrier,
// exp (one per 64 FMAs at V = 64) and row copies, more than the FMAs.
// Tensor cores are not used (TF32 would not hold parity with the f32
// oracle), there is no fast math, and ragged edges are masked by index.
//
// Every function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;
constexpr int TM = 32;      // owned indices a block: rows (dscale) or keys (dv)
constexpr int TK = 16;      // streamed indices a step
constexpr int TN = 64;      // value columns of each head a block
constexpr int LCAP = 1024;  // the compacted list of streamed indices
// blocks of four warps resident on an SM: up to 168 registers a thread,
// none spilled at four heads (the cap of four blocks, 128, spills)
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sqdist(const float (&q)[MAX_DIM], const float* k, int dd) {
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

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The inputs of one launch. COORDS: distances from mq/mk (and the band);
// otherwise read from dist.
struct Args {
  const float* dist;    // (B, Lo, Li) or null
  const float* mq;      // (B, Lo, dd) or null
  const float* mk;      // (B, Li, dd) or null
  const float* scale;   // (H)
  const float* values;  // (B, Li, H*V); dscale only
  const float* out;     // the forward's output O (B, Lo, H*V); dscale only
  const float* g;       // (B, Lo, H*V)
  const float* stats;   // (B, H+2, Lo)
  const int* starts;    // (B, n_tiles) or null
  float* partial;       // (B, H, nparts); dscale only
  float* res;           // ds (B, H) or dv (B, Li, H*V)
  int Lo, Li, H, V, dd, width, tile_rows, n_tiles;
  bool vec4;            // the V or G rows copy in 16-byte pieces (V % 4 == 0, aligned)
};

// the window [*j_begin, *j_end) of band tile t of sample b; the whole key
// axis without a band
__device__ __forceinline__ void window(const Args& a, int b, int t, int* j_begin, int* j_end) {
  if (a.starts == nullptr) { *j_begin = 0; *j_end = a.Li; return; }
  const int s = a.starts[(size_t)b * a.n_tiles + t];
  *j_begin = max(s, 0);
  *j_end = min(s + a.width, a.Li);
}

// What a block keeps in shared memory (dynamic: above the 48 KB of a
// static allocation). The step's x and the V or G rows are double
// buffered: step s + 1's are written while step s's are used.
template <int HG>
struct Smem {
  __align__(16) float v[2][HG][TK][TN];  // each head's V (dscale) or G (dv) rows
  __align__(16) float w[HG][TK][TM];     // each head's weights: W (dscale) or P (dv)
  float x[2][TK][TM + 1];  // x = d - dmin of a step's entries, -1 where not kept
  int list[LCAP];          // the streamed indices that keep an entry
  float oq[TM][MAX_DIM];   // the owned indices' coordinates
  float odmin[TM], othr[TM];  // dscale: the owned rows' statistics
  float orden[HG][TM];
  float srden[2][HG][TK];  // dv: the step's rows' rden per head
  float vrow[HG][TM];      // dscale: v_i per head
  int cnt[HG];
};

// A streamed index c of sample b (dscale: key c; dv: row c) and what the
// entries with the owned indices need of it: the coordinates, and for a
// row its keep threshold and bare minimum.
template <bool COORDS>
struct Streamed {
  float q[COORDS ? MAX_DIM : 1];
  float t, mn;
  int c;
  bool ok;
};

template <bool COORDS, bool DV>
__device__ __forceinline__ Streamed<COORDS> streamed(const Args& a, int b, int c, bool ok) {
  Streamed<COORDS> st;
  st.c = ok ? c : 0;
  st.ok = ok;
  const float* src = DV ? a.mq + ((size_t)b * a.Lo + st.c) * a.dd
                        : (COORDS ? a.mk + ((size_t)b * a.Li + st.c) * a.dd : nullptr);
  if constexpr (COORDS) {
#pragma unroll
    for (int k = 0; k < MAX_DIM; ++k) st.q[k] = k < a.dd ? __ldg(src + k) : 0.f;
  }
  if (DV) {
    const float* stb = a.stats + (size_t)b * (a.H + 2) * a.Lo;
    st.t = __ldg(stb + a.Lo + st.c);
    st.mn = __ldg(stb + st.c);
  }
  return st;
}

// The block's owned indices are o0 + o, o < TM, of sample b. The distance
// of the entry between owned index o and the streamed index (dscale: row
// o0 + o, key st.c; dv: row st.c, key o0 + o) from the coordinates, or read
// from dist.
template <bool COORDS, bool DV, int HG>
__device__ __forceinline__ float entry_dist(const Args& a, const Smem<HG>& sm, int b, int o0,
                                            int o, const Streamed<COORDS>& st) {
  if constexpr (COORDS) {
    return DV ? sqdist(st.q, sm.oq[o], a.dd) : sqdist(sm.oq[o], st.q, a.dd);
  } else {
    const int i = DV ? st.c : o0 + o;
    const int j = DV ? o0 + o : st.c;
    return __ldg(a.dist + ((size_t)b * a.Lo + min(i, a.Lo - 1)) * a.Li + min(j, a.Li - 1));
  }
}

// x of that entry, whose distance is d, when it is kept, else -1. [wb, we)
// is the window of the band tile the rows are in.
template <bool COORDS, bool DV, int HG>
__device__ __forceinline__ float kept_x(const Args& a, const Smem<HG>& sm, int o0, int o,
                                        const Streamed<COORDS>& st, float d, int wb, int we) {
  const int i = DV ? st.c : o0 + o;
  const int j = DV ? o0 + o : st.c;
  if (!st.ok || i >= a.Lo || j < wb || j >= we) return -1.f;
  const float t = DV ? st.t : sm.othr[o];
  const float mn = DV ? st.mn : sm.odmin[o];
  return d <= t ? __fsub_rn(d, mn) : -1.f;
}

// Block-uniform: appends to sm.list, from *n on, the streamed indices of
// [*c, c_end) that keep an entry with an owned index, in order, until the
// range ends or the list has no room for another round; advances *c.
template <bool COORDS, bool DV, int HG>
__device__ void compact(const Args& a, Smem<HG>& sm, int b, int o0, int* c, int c_end, int wb,
                        int we, int* n) {
  constexpr int THREADS = HG * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  while (*c < c_end && *n + THREADS <= LCAP) {
    const int cand = *c + tid;
    const Streamed<COORDS> st = streamed<COORDS, DV>(a, b, cand, cand < c_end);
    bool any = false;
    // eight owned indices at a time: their loads in flight together
    for (int o = 0; o < TM && !any; o += 8) {
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = entry_dist<COORDS, DV, HG>(a, sm, b, o0, o + u, st);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        any |= kept_x<COORDS, DV, HG>(a, sm, o0, o + u, st, d[u], wb, we) >= 0.f;
    }
    const unsigned m = __ballot_sync(0xffffffffu, any);
    if (lane == 0) sm.cnt[warp] = __popc(m);
    __syncthreads();
    int off = *n, total = *n;
    for (int w = 0; w < HG; ++w) {
      if (w < warp) off += sm.cnt[w];
      total += sm.cnt[w];
    }
    if (any) sm.list[off + __popc(m & ((1u << lane) - 1u))] = cand;
    __syncthreads();  // the counts are read before the next round writes them
    *n = total;
    *c += THREADS;
  }
}

// A block: the owned tile blockIdx.y of sample blockIdx.z; head group and
// column tile from blockIdx.x. Warp h owns head h0 + h; lane (og, cg) =
// (lane / 8, lane % 8) owns the owned indices og*4 + {0..3} and
// 16 + og*4 + {0..3} and the columns cg*4 + {0..3} and 32 + cg*4 + {0..3}
// of the tile.
template <bool COORDS, bool DV, int HG>
__global__ void __launch_bounds__(HG * 32, MIN_BLOCKS * 4 / HG) tf_bwd_kernel(const Args a) {
  constexpr int THREADS = HG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HG>& sm = *reinterpret_cast<Smem<HG>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ct = (a.V + TN - 1) / TN;
  const int grp = blockIdx.x / n_ct;
  const int ct = blockIdx.x - grp * n_ct;
  const int col0 = ct * TN;
  const int h0 = grp * HG;
  const int h = h0 + warp;  // this warp's head
  const bool head_ok = h < a.H;
  const int o0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V;
  const float s = head_ok ? a.scale[h] : 0.f;
  const float* stb = a.stats + (size_t)b * (a.H + 2) * Lo;

  // ---- the owned indices' coordinates and (dscale) row statistics
  if (COORDS) {
    for (int e = tid; e < TM * MAX_DIM; e += THREADS) {
      const int o = e / MAX_DIM, k = e - o * MAX_DIM;
      const int i = o0 + o;
      const int L = DV ? Li : Lo;
      const float* src = DV ? a.mk : a.mq;
      sm.oq[o][k] = (i < L && k < a.dd) ? src[((size_t)b * L + i) * a.dd + k] : 0.f;
    }
  }
  if (!DV) {
    for (int o = tid; o < TM; o += THREADS) {
      const int i = o0 + o;
      sm.odmin[o] = i < Lo ? stb[i] : 0.f;
      sm.othr[o] = i < Lo ? stb[Lo + i] : -INFINITY;
    }
    for (int e = tid; e < HG * TM; e += THREADS) {
      const int hh = e / TM, o = e - hh * TM;
      const int i = o0 + o;
      sm.orden[hh][o] =
          (i < Lo && h0 + hh < a.H) ? stb[(size_t)(2 + h0 + hh) * Lo + i] : 0.f;
    }
  }
  __syncthreads();

  const int og = lane >> 3, cg = lane & 7;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float vsum = 0.f;  // dscale: v of row o0 + lane, this warp's head
  const float ord = DV ? 0.f : sm.orden[warp][lane];
  // the rows whose V (dscale) or G (dv) values this warp stages
  const float* vsrc = (DV ? a.g + (size_t)b * Lo * HV : a.values + (size_t)b * Li * HV) +
                      (size_t)(head_ok ? h : 0) * a.V + col0;
  const bool c0_ok = col0 + lane < a.V, c1_ok = col0 + lane + 32 < a.V;

  // A thread's share of a step's x tile: FILL entries (k, o). k runs
  // fastest (one streamed index a thread: a row's keys are contiguous in
  // dist), but for dv over dist, where o does (a key row is).
  constexpr int FILL = TK * TM / THREADS;
  constexpr bool O_FASTEST = DV && !COORDS;
  constexpr int NST = O_FASTEST ? FILL : 1;  // streamed indices a thread
  auto entry = [&](int q, int* k, int* o) {
    const int e = tid + q * THREADS;
    *k = O_FASTEST ? e / TM : e % TK;
    *o = O_FASTEST ? e % TM : e / TK;
  };
  // what a thread's share of step s0's fill reads from device memory,
  // loaded a step ahead so that the loads are in flight during a
  // contraction
  struct Pending {
    Streamed<COORDS> st[NST];
    float d[FILL];
    float rden;  // dv: one of the step's rows' rden
  };
  auto fill_load = [&](int s0, int n) {
    Pending p;
#pragma unroll
    for (int u = 0; u < NST; ++u) {
      int k, o;
      entry(u, &k, &o);
      const bool ok = s0 + k < n;
      p.st[u] = streamed<COORDS, DV>(a, b, ok ? sm.list[s0 + k] : 0, ok);
    }
#pragma unroll
    for (int q = 0; q < FILL; ++q) {
      int k, o;
      entry(q, &k, &o);
      p.d[q] = COORDS ? 0.f
                      : entry_dist<COORDS, DV, HG>(a, sm, b, o0, o, p.st[O_FASTEST ? q : 0]);
    }
    p.rden = 0.f;
    if (DV && tid < HG * TK) {
      const int hh = tid / TK, k = tid - hh * TK;
      if (s0 + k < n && h0 + hh < a.H)
        p.rden = stb[(size_t)(2 + h0 + hh) * Lo + sm.list[s0 + k]];
    }
    return p;
  };
  // x (and for dv the rows' rden) of a step into buffer xb
  auto fill_store = [&](const Pending& p, int xb, int wb, int we) {
#pragma unroll
    for (int q = 0; q < FILL; ++q) {
      int k, o;
      entry(q, &k, &o);
      const Streamed<COORDS>& st = p.st[O_FASTEST ? q : 0];
      const float d = COORDS ? entry_dist<COORDS, DV, HG>(a, sm, b, o0, o, st) : p.d[q];
      sm.x[xb][k][o] = kept_x<COORDS, DV, HG>(a, sm, o0, o, st, d, wb, we);
    }
    if (DV && tid < HG * TK) sm.srden[xb][tid / TK][tid % TK] = p.rden;
  };
  // warp: start copying this head's V or G rows of step s0 into buffer vb
  auto stage = [&](int s0, int n, int vb) {
    if (a.vec4) {  // 16 pieces of 4 columns a row
#pragma unroll
      for (int q = 0; q < TK * TN / 4 / 32; ++q) {
        const int e = lane + q * 32;
        const int k = e / (TN / 4), c4 = (e - k * (TN / 4)) * 4;
        const bool ok = s0 + k < n && col0 + c4 < a.V;
        const float* p = vsrc + (size_t)(s0 + k < n ? sm.list[s0 + k] : 0) * HV + c4;
        cp_async16(&sm.v[vb][warp][k][c4], ok ? p : vsrc, ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const bool ok = s0 + k < n;
        const float* p = vsrc + (size_t)(ok ? sm.list[s0 + k] : 0) * HV;
        cp_async4(&sm.v[vb][warp][k][lane], ok && c0_ok ? p + lane : vsrc, ok && c0_ok);
        cp_async4(&sm.v[vb][warp][k][lane + 32], ok && c1_ok ? p + lane + 32 : vsrc,
                  ok && c1_ok);
      }
    }
    cp_async_commit();
  };

  // contract over the listed streamed indices [0, n), pipelined: while
  // step s is weighted and contracted, step s + 1's rows are in flight and
  // its x is computed; one block barrier a step
  auto contract = [&](int n, int wb, int we) {
    if (n == 0) return;  // block-uniform
    fill_store(fill_load(0, n), 0, wb, we);
    if (head_ok) stage(0, n, 0);
    __syncthreads();
    int buf = 0;
    for (int s0 = 0; s0 < n; s0 += TK, buf ^= 1) {
      const bool more = s0 + TK < n;
      const Pending next = fill_load(s0 + TK, n);  // nothing past the list
      if (head_ok) {  // warp-uniform
        if (more) stage(s0 + TK, n, buf ^ 1);
        // this head's weights: lane = owned index
#pragma unroll
        for (int k = 0; k < TK; ++k) {
          const float x = sm.x[buf][k][lane];
          float w = 0.f;
          if (x >= 0.f) {
            if (DV) {
              w = expf(-x * s) * sm.srden[buf][warp][k];
            } else {
              w = expf(-x * s) * ord * -x;
              vsum += w;
            }
          }
          sm.w[warp][k][lane] = w;
        }
        if (more) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncwarp();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
          float wv[8], vv[8];
          lds4(&sm.w[warp][k][og * 4], wv);
          lds4(&sm.w[warp][k][16 + og * 4], wv + 4);
          lds4(&sm.v[buf][warp][k][cg * 4], vv);
          lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
        }
      }
      if (more) fill_store(next, buf ^ 1, wb, we);
      __syncthreads();  // step s's buffers are free, step s + 1's x is visible
    }
  };

  // ---- the streamed ranges: compact, then contract
  if (!DV) {
    int wb, we;
    window(a, b, o0 / a.tile_rows, &wb, &we);
    for (int c = wb; c < we;) {
      int n = 0;
      compact<COORDS, DV, HG>(a, sm, b, o0, &c, we, wb, we, &n);
      contract(n, wb, we);
    }
  } else {
    const int n_t = a.starts != nullptr ? a.n_tiles : 1;
    for (int t = 0; t < n_t; ++t) {
      int wb, we;
      window(a, b, t, &wb, &we);
      if (max(wb, o0) >= min(we, min(o0 + TM, Li))) continue;  // no owned key in the window
      const int i_end = a.starts != nullptr ? min((t + 1) * a.tile_rows, Lo) : Lo;
      for (int c = a.starts != nullptr ? t * a.tile_rows : 0; c < i_end;) {
        int n = 0;
        compact<COORDS, DV, HG>(a, sm, b, o0, &c, i_end, wb, we, &n);
        contract(n, wb, we);
      }
    }
  }
  if (!head_ok) return;  // warp-uniform; no block barrier follows

  // ---- epilogue
  const int rows[8] = {og * 4, og * 4 + 1, og * 4 + 2, og * 4 + 3,
                       16 + og * 4, 16 + og * 4 + 1, 16 + og * 4 + 2, 16 + og * 4 + 3};
  const int cols[8] = {cg * 4, cg * 4 + 1, cg * 4 + 2, cg * 4 + 3,
                       32 + cg * 4, 32 + cg * 4 + 1, 32 + cg * 4 + 2, 32 + cg * 4 + 3};
  if (DV) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = o0 + rows[r];
      if (j >= Li) continue;
      float* dst = a.res + ((size_t)b * Li + j) * HV + (size_t)h * a.V + col0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (col0 + cols[c] < a.V) dst[cols[c]] = acc[r][c];
    }
  } else {
    // sum over the block's (i, k) of G * (Y - v O)
    sm.vrow[warp][lane] = vsum;
    __syncwarp();
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = o0 + rows[r];
      if (i >= Lo) continue;
      const float vi = sm.vrow[warp][rows[r]];
      const size_t base = ((size_t)b * Lo + i) * HV + (size_t)h * a.V + col0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (col0 + cols[c] < a.V)
          part = fmaf(a.g[base + cols[c]], acc[r][c] - vi * a.out[base + cols[c]], part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      const size_t nparts = (size_t)gridDim.y * n_ct;
      a.partial[((size_t)b * a.H + h) * nparts + (size_t)blockIdx.y * n_ct + ct] = part;
    }
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

// heads a block: 1, 2 or 4 (a warp each), the least power of two that
// holds H up to 4
template <bool COORDS, bool DV, int HG>
int launch_group(const Args& a, int B, cudaStream_t s) {
  constexpr int smem = (int)sizeof(Smem<HG>);
  int rc = (int)cudaFuncSetAttribute(tf_bwd_kernel<COORDS, DV, HG>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int n_ct = (a.V + TN - 1) / TN;
  const dim3 grid((a.H + HG - 1) / HG * n_ct, ((DV ? a.Li : a.Lo) + TM - 1) / TM, B);
  tf_bwd_kernel<COORDS, DV, HG><<<grid, HG * 32, smem, s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0 || DV) return rc;
  sum_partials_kernel<<<B * a.H, 32, 0, s>>>(a.partial, a.res, (int)(grid.y * n_ct));
  return (int)cudaGetLastError();
}

template <bool COORDS, bool DV>
int launch(const Args& a, int B, cudaStream_t s) {
  if (a.H == 1) return launch_group<COORDS, DV, 1>(a, B, s);
  if (a.H == 2) return launch_group<COORDS, DV, 2>(a, B, s);
  return launch_group<COORDS, DV, 4>(a, B, s);
}

bool bad_shape(int B, int Lo, int Li, int H, int V) {
  return B < 1 || Lo < 1 || Li < 1 || H < 1 || V < 1 || B > 65535 ||
         (Lo + TM - 1) / TM > 65535 || (Li + TM - 1) / TM > 65535;
}

bool bad_coords(int Lo, int dd, int tile_rows, const int* starts, int width) {
  // a block of TM rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TM == 0);
  return dd < 1 || dd > MAX_DIM || !tiles_ok || (starts != nullptr && width < 1);
}

// the rows copy in 16-byte pieces: V a multiple of 4 and both sources aligned
bool vec4(const float* values, const float* g, int V) {
  return V % 4 == 0 && reinterpret_cast<size_t>(values) % 16 == 0 &&
         reinterpret_cast<size_t>(g) % 16 == 0;
}

Args dist_args(const float* dist, const float* scale, const float* values, const float* out,
               const float* g, const float* stats, float* partial, float* res, int Lo, int Li,
               int H, int V) {
  return Args{dist, nullptr, nullptr, scale, values, out, g, stats, nullptr, partial, res,
              Lo, Li, H, V, 0, 0, Lo, 1, vec4(values, g, V)};
}

Args coord_args(const float* mq, const float* mk, const float* scale, const float* values,
                const float* out, const float* g, const float* stats, const int* starts,
                float* partial, float* res, int Lo, int Li, int H, int V, int dd, int width,
                int tile_rows) {
  return Args{nullptr, mq, mk, scale, values, out, g, stats, starts, partial, res,
              Lo, Li, H, V, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows,
              vec4(values, g, V)};
}

}  // namespace

// partial: B * H * ceil(Lo/32) * ceil(V/64) floats of scratch
extern "C" int posatt_tf_bwd_dscale(const float* dist, const float* scale, const float* values,
                                    const float* out, const float* g, const float* stats,
                                    float* partial, float* ds, int B, int Lo, int Li, int H,
                                    int V, void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  return launch<false, false>(
      dist_args(dist, scale, values, out, g, stats, partial, ds, Lo, Li, H, V), B,
      static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_bwd_dv(const float* dist, const float* scale, const float* g,
                                const float* stats, float* dv, int B, int Lo, int Li, int H,
                                int V, void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  return launch<false, true>(
      dist_args(dist, scale, nullptr, nullptr, g, stats, nullptr, dv, Lo, Li, H, V), B,
      static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_bwd_dscale(const float* mq, const float* mk, const float* scale,
                                          const float* values, const float* out, const float* g,
                                          const float* stats, const int* starts, float* partial,
                                          float* ds, int B, int Lo, int Li, int H, int V, int dd,
                                          int width, int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, H, V) || bad_coords(Lo, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  return launch<true, false>(coord_args(mq, mk, scale, values, out, g, stats, starts, partial,
                                        ds, Lo, Li, H, V, dd, width, tile_rows),
                             B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_bwd_dv(const float* mq, const float* mk, const float* scale,
                                      const float* g, const float* stats, const int* starts,
                                      float* dv, int B, int Lo, int Li, int H, int V, int dd,
                                      int width, int tile_rows, void* stream) {
  if (bad_shape(B, Lo, Li, H, V) || bad_coords(Lo, dd, tile_rows, starts, width))
    return (int)cudaErrorInvalidValue;
  return launch<true, true>(coord_args(mq, mk, scale, nullptr, nullptr, g, stats, starts,
                                       nullptr, dv, Lo, Li, H, V, dd, width, tile_rows),
                            B, static_cast<cudaStream_t>(stream));
}
