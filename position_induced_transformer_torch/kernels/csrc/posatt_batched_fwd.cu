// Per-sample-mesh position attention, forward pass, hand-written for
// Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel _make_fwd_kernel, launched by _posatt_batched_raw
// (pallas_call at position_induced_transformer_tpu/kernels/
// posatt_batched.py:278). For sample b, output row i, head h and value
// column k, over the row's column window W (the whole key axis, or the
// band [start, start + width) of the extended key axis, start =
// starts[b, i / tile_rows], clipped to the key axis):
//
//   d[i,j]   = sum_c (q[i,c] - k[j,c])^2   (diff, square, sum in c order)
//   keep     = d <= thr[b,i]; or, without thr, d at or below the
//              keep_count-th smallest distinct value of the row; or every
//              column when keep_count >= L_in
//   dmin[i]  = min over W of d (the bare minimum)
//   p[h,i,j] = keep ? exp(-(d - dmin) * scale[h]) : 0
//   out[b, i, h*D + k] = sum_j p u[b,j,k] / max(sum_j p, 1e-30)
//
// With a non-null `stats` it also writes, per row, dmin, the keep
// threshold (+inf where every column is kept) and per head the reciprocal
// denominator, (B, H + 2, Lo): the residuals the backward kernels need.
//
// What bounds it on this card: its inputs and output are small (the
// coordinates, the values and the (B, Lo, H*D) output), so bytes bound it
// only where few columns are kept. It does 3*d operations per distance
// inspected and 2*H*D per kept entry; at the elasticity processor every
// entry is kept (972 x 972 per sample, D = 256), which puts it far above
// the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20 operations per byte): the f32
// CUDA-core rate bounds it there, about 0.145 ms a launch.
//
// What the design does about it (the pattern of posatt_tf_fwd.cu's
// tf_kernel and posatt_batched_bwd.cu's dscale, with the values shared by
// the heads):
// - A block owns 32 rows of one sample, a group of HB heads and NS slabs of
//   64 value columns: a warp per (head, slab). It computes each (i, j)
//   distance of its window once, with __fsub_rn / __fmul_rn / __fadd_rn so
//   that no FMA contraction changes it (bit for bit
//   ops/distances.euclidean_sq's, which matters where the kernel's own
//   distances choose the kept set), and each kept entry's weight once per
//   head, for every column it owns.
// - A block stays inside one band tile, so its window is block-uniform:
//   band_tile_rows(L_out) = min(round_up(L_out, 8), 256) is a multiple of
//   32 or covers every row, so a 32-row block never straddles two band
//   starts (the launcher refuses a tile height for which it would).
// - Pass 1 scans the window once: per row the bare minimum and, from the
//   same distances, a compacted, ordered list of the columns any of the
//   block's rows keeps (warp ballots in shared memory, refilled in rounds
//   when a window keeps more than LCAP columns). Without thresholds and with
//   a keep count below L_in, the keep count's distinct value is found by
//   keep_count - 1 masked-minimum scans of the window, and the list is
//   built after them.
// - Pass 2 contracts over the list only. Each step's entries are weighted
//   by one thread each (its distance and one exp a head, branch-free, so
//   that the exps interleave with the products of the step before) into
//   shared memory, where the NS slab warps of a head read them; each
//   denominator is summed beside the products by the threads that weight
//   its row and the shares are added in a fixed order at the end, where
//   the output is normalised. Register tiles of 8 x 8 outputs per lane, read
//   as conflict-free float4s (64 FMAs per four 16-byte loads). Pipelined,
//   one block barrier a step: while step s is contracted, step s + 1's
//   value rows are in flight (cp.async, 16-byte pieces where D % 4 == 0)
//   and its coordinates are loaded.
// - Any head count: a block owns a group of HB <= 8 heads (ceil(H/8)
//   groups as even as can be; HB = H up to 8 heads), and a short last group
//   masks its missing heads. Ragged rows, window columns and value columns
//   are masked by index; D may be any width.
// Tensor cores are not used (TF32 would not hold parity with the f32
// oracle) and there is no fast math. Sums in fixed orders: the same bits on
// every run.
//
// The function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;    // coordinates per point
constexpr int TM = 32;        // rows a block
constexpr int TK = 16;        // listed columns a step (at most)
constexpr int TN = 64;        // value columns a warp
constexpr int LCAP = 1024;    // the compacted list of kept columns
constexpr int SM_WARPS = 12;  // resident warps a SM the register cap allows

// squared distance in the op order of ops/distances.euclidean_sq, without
// contraction into FMAs
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

// a 16-byte store of v[0..3] * f
__device__ __forceinline__ void st4(float* p, const float* v, float f) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0] * f, v[1] * f, v[2] * f, v[3] * f);
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

// One step of a transposing butterfly: v[i], i < 2*OFF, holds rows r(i);
// a lane keeps the half of them its bit OFF selects, and takes the minimum
// with its partner's copy of that half.
template <int OFF>
__device__ __forceinline__ void min_step(float (&v)[TM], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
  }
}

// Lane l of a warp ends with the minimum over the warp's lanes of v[l]:
// 31 exchanges for 32 rows.
__device__ __forceinline__ float warp_min_rows(float (&v)[TM], int lane) {
  min_step<16>(v, lane);
  min_step<8>(v, lane);
  min_step<4>(v, lane);
  min_step<2>(v, lane);
  min_step<1>(v, lane);
  return v[0];
}

// The inputs of one launch.
struct Args {
  const float* mq;     // (B, Lo, dd)
  const float* mk;     // (B, Li, dd)
  const float* scale;  // (H)
  const float* u;      // (B, Li, D)
  const float* thr;    // (B, Lo) or null
  const int* starts;   // (B, n_tiles) or null
  float* out;          // (B, Lo, H*D)
  float* stats;        // (B, H+2, Lo) or null
  int H, Lo, Li, D, dd, keep_count, width, tile_rows, n_tiles;
  bool vec4;           // value and output rows move in 16-byte pieces (D % 4 == 0, aligned)
};

// The shape of a block: HB heads by NS column slabs, a warp each.
template <int HB, int NS>
struct Shape {
  static constexpr int NW = HB * NS;  // warps
  static constexpr int THREADS = NW * 32;
  static constexpr int CW = NS * TN;  // value columns a block
  // listed columns a step: at most four a thread weights (FQ), so that
  // their coordinates, loaded a step ahead, fit in registers
  static constexpr int SK = TK < 4 * NW ? TK : 4 * NW;
  static constexpr int FQ = (SK + NW - 1) / NW;
  static constexpr int MIN_BLOCKS = SM_WARPS / NW > 0 ? SM_WARPS / NW : 1;
};

// What a block keeps in shared memory (dynamic: above the 48 KB of a
// static allocation at eight heads). The value rows and the weights are
// double buffered: step s + 1's are written while step s's are used.
template <int HB, int NS>
struct Smem {
  using S = Shape<HB, NS>;
  __align__(16) float v[2][S::SK][S::CW];    // the listed columns' value rows
  __align__(16) float w[2][HB * S::SK][TM];  // weights, [h*SK + k][row]
  int list[LCAP];                            // the window's columns that a row keeps, in order
  float oq[TM][MAX_DIM];                     // the rows' coordinates
  float othr[TM];                            // the rows' keep thresholds
  float odmin[TM];                           // the rows' bare window minima
  float wmin[S::NW][TM];                     // each warp's share of a minimum per row
  float dpart[S::NW][HB][TM];                // each warp's share of the denominators
  float rden[HB][TM];                        // the reciprocal denominators
  int cnt[S::NW];
};

// A block: rows o0 = 32*blockIdx.y.. of sample blockIdx.z; head group and
// column tile from blockIdx.x. Warp w owns head h0 + w / NS and the 64
// columns of slab w % NS; its lane (og, cg) = (lane / 8, lane % 8) owns the
// rows og*4 + {0..3} and 16 + og*4 + {0..3} and the columns cg*4 + {0..3}
// and 32 + cg*4 + {0..3} of the slab. In the weighting, lane o weights the
// entries of row o.
template <int HB, int NS>
__global__ void __launch_bounds__(Shape<HB, NS>::THREADS, Shape<HB, NS>::MIN_BLOCKS)
fwd_kernel(const Args a) {
  using S = Shape<HB, NS>;
  constexpr int NW = S::NW, THREADS = S::THREADS, CW = S::CW, SK = S::SK, FQ = S::FQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HB, NS>& sm = *reinterpret_cast<Smem<HB, NS>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Lo = a.Lo, Li = a.Li, D = a.D, dd = a.dd;
  const int n_ct = (D + CW - 1) / CW;
  const int grp = blockIdx.x / n_ct;
  const int ct = blockIdx.x - grp * n_ct;
  const int col0 = ct * CW;
  const int h0 = grp * HB;  // the group's first head
  const int o0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const int wh = warp / NS, slab = warp % NS;  // this warp's head in the group, slab
  const bool head_ok = h0 + wh < H;            // warp-uniform
  const float* mkb = a.mk + (size_t)b * Li * dd;

  // the block's window, the same for all its rows
  int wb = 0, we = Li;
  if (a.starts != nullptr) {
    const int st = a.starts[(size_t)b * a.n_tiles + o0 / a.tile_rows];
    wb = max(st, 0);
    we = min(st + a.width, Li);
  }
  for (int e = tid; e < TM * MAX_DIM; e += THREADS) {
    const int o = e / MAX_DIM, k = e - o * MAX_DIM;
    const int i = o0 + o;
    sm.oq[o][k] = (i < Lo && k < dd) ? a.mq[((size_t)b * Lo + i) * dd + k] : 0.f;
  }
  // without thr and with a keep count below L_in the threshold is found
  // after the minimum: until then every column is a candidate
  const bool count_keep = a.thr == nullptr && a.keep_count < Li;  // block-uniform
  for (int o = tid; o < TM; o += THREADS) {
    const int i = o0 + o;
    // a padded row keeps nothing
    sm.othr[o] = i >= Lo ? -INFINITY : (a.thr != nullptr ? a.thr[(size_t)b * Lo + i] : INFINITY);
  }
  __syncthreads();

  auto key = [&](int c, bool ok, float (&kq)[MAX_DIM]) {
#pragma unroll
    for (int k = 0; k < MAX_DIM; ++k) kq[k] = ok && k < dd ? __ldg(mkb + (size_t)c * dd + k) : 0.f;
  };

  // Block-uniform: one round of the compaction. Appends to sm.list, from
  // *n on, the candidate column cand of each thread when `any` (a row
  // keeps it), in order.
  auto append = [&](bool any, int cand, int* n) {
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
  };
  // Block-uniform: one scan of the window, a column a thread. Per row the
  // minimum of the distances (of those above sm.othr when `above`) into
  // dst[TM]; with `list`, from the same distances, the columns a row keeps
  // (d <= sm.othr) into sm.list, in order, while they fit: returns their
  // count and sets *resume to the first column whose round did not fit
  auto scan = [&](bool above, bool list, float* dst, int* resume) {
    int n = 0;
    float mn[TM];
#pragma unroll
    for (int o = 0; o < TM; ++o) mn[o] = INFINITY;
    for (int c0 = wb; c0 < we; c0 += THREADS) {
      const int c = c0 + tid;
      const bool ok = c < we;
      float kq[MAX_DIM];
      key(c, ok, kq);
      bool any = false;
#pragma unroll
      for (int o = 0; o < TM; ++o) {
        const float d = sqdist(sm.oq[o], kq, dd);
        if (ok && (!above || d > sm.othr[o])) mn[o] = fminf(mn[o], d);
        any |= ok && d <= sm.othr[o];
      }
      if (list && *resume == we) {  // block-uniform
        if (n + THREADS <= LCAP)
          append(any, c, &n);
        else
          *resume = c0;
      }
    }
    sm.wmin[warp][lane] = warp_min_rows(mn, lane);
    __syncthreads();
    for (int o = tid; o < TM; o += THREADS) {
      float m = sm.wmin[0][o];
#pragma unroll
      for (int w = 1; w < NW; ++w) m = fminf(m, sm.wmin[w][o]);
      dst[o] = m;
    }
    __syncthreads();
    return n;
  };

  // ---- pass 1: each row's bare window minimum and, from the same
  // distances, the list of kept columns; `resume` is the first column
  // whose round did not fit in the list (with a keep count: all of them)
  int resume = we;
  const int n = scan(false, !count_keep, sm.odmin, &resume);
  if (count_keep) {
    for (int o = tid; o < TM; o += THREADS) sm.othr[o] = sm.odmin[o];
    __syncthreads();
    // the keep count's distinct value: keep_count - 1 masked minima
    for (int r = 1; r < a.keep_count; ++r) scan(true, false, sm.othr, &resume);
    for (int o = tid; o < TM; o += THREADS)
      if (o0 + o >= Lo) sm.othr[o] = -INFINITY;
    __syncthreads();
    resume = wb;
  }

  // this lane's row, for the weighting
  float oq[MAX_DIM], sh[HB], dacc[HB];
#pragma unroll
  for (int k = 0; k < MAX_DIM; ++k) oq[k] = sm.oq[lane][k];
  const float othr = sm.othr[lane], odmin = sm.odmin[lane];
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    sh[h] = h0 + h < H ? __ldg(a.scale + h0 + h) : 0.f;  // a missing head: 0, finite
    dacc[h] = 0.f;  // this thread's share of row lane's denominator
  }

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // What a thread's share of a step's weighting reads from device memory,
  // loaded a step ahead so that the loads are in flight during a
  // contraction: the listed columns k = warp + q*NW < SK of the step (the
  // same for every lane of a warp) and their coordinates.
  struct Pending {
    float q[FQ][MAX_DIM];
    int c[FQ];  // the column; -1 past the list
  };
  auto fill_load = [&](int s0, int nl) {
    Pending p;
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int k = warp + q * NW;
      const bool ok = k < SK && s0 + k < nl;
      const int c = ok ? sm.list[s0 + k] : 0;
      key(c, true, p.q[q]);
      p.c[q] = ok ? c : -1;
    }
    return p;
  };
  // the step's weights into buffer buf: one distance and one exp a head
  // per entry. Branch-free (past the list, or not kept: 0), so that the
  // compiler can interleave it with the products of the step before.
  auto fill_store = [&](const Pending& p, int buf) {
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int k = warp + q * NW;
      if (SK % NW != 0 && k >= SK) continue;  // warp-uniform
      const float d = sqdist(oq, p.q[q], dd);
      const bool kept = p.c[q] >= 0 && d <= othr;
      const float x = kept ? __fsub_rn(d, odmin) : 0.f;
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const float e = expf(-x * sh[h]);
        const float pw = kept ? e : 0.f;
        dacc[h] += pw;
        sm.w[buf][h * SK + k][lane] = pw;
      }
    }
  };
  // the block: start copying step s0's value rows into buffer buf
  auto stage = [&](int s0, int nl, int buf) {
    if (a.vec4) {  // CW/4 pieces of 4 columns a row
#pragma unroll
      for (int e0 = 0; e0 < SK * CW / 4; e0 += THREADS) {
        const int e = e0 + tid;
        if ((SK * CW / 4) % THREADS == 0 || e < SK * CW / 4) {  // predicated, no break
          const int r = e / (CW / 4), c4 = (e - r * (CW / 4)) * 4;
          const bool ok = s0 + r < nl && col0 + c4 < D;
          const float* src = a.u + ((size_t)b * Li + (s0 + r < nl ? sm.list[s0 + r] : 0)) * D;
          cp_async16(&sm.v[buf][r][c4], ok ? src + col0 + c4 : a.u, ok);
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < SK * CW; e += THREADS) {
        const int r = e / CW, c = e - r * CW;
        const bool ok = s0 + r < nl && col0 + c < D;
        const float* src = a.u + ((size_t)b * Li + (s0 + r < nl ? sm.list[s0 + r] : 0)) * D;
        cp_async4(&sm.v[buf][r][c], ok ? src + col0 + c : a.u, ok);
      }
    }
    cp_async_commit();
  };

  const int og = lane >> 3, cg = lane & 7;
  // ---- pass 2: contract over the listed columns [0, nl), pipelined: while
  // step s is contracted, step s + 1's value rows are in flight and its
  // weights are computed; one block barrier a step. A warp of a missing
  // head contracts weights it never writes out.
  auto contract = [&](int nl) {
    if (nl == 0) return;  // block-uniform
    stage(0, nl, 0);
    fill_store(fill_load(0, nl), 0);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;
    for (int s0 = 0; s0 < nl; s0 += SK, buf ^= 1) {
      const bool more = s0 + SK < nl;  // block-uniform
      if (more) stage(s0 + SK, nl, buf ^ 1);
      const Pending next = fill_load(s0 + SK, nl);  // nothing past the list
#pragma unroll
      for (int k = 0; k < SK; ++k) {
        const float* wr = sm.w[buf][wh * SK + k];
        const float* vr = &sm.v[buf][k][slab * TN];
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
      fill_store(next, buf ^ 1);  // past the list: zeros, never read
      cp_async_wait_all();
      __syncthreads();  // step s's buffers are free, step s + 1's are visible
    }
  };

  contract(n);
  // the columns whose rounds did not fit in the list, in list-sized rounds
  for (int c0 = resume; c0 < we;) {
    int nl = 0;
    while (c0 < we && nl + THREADS <= LCAP) {
      const int c = c0 + tid;
      bool any = false;
      if (c < we) {
        float kq[MAX_DIM];
        key(c, true, kq);
        for (int o = 0; o < TM && !any; ++o) any = sqdist(sm.oq[o], kq, dd) <= sm.othr[o];
      }
      append(any, c, &nl);
      c0 += THREADS;
    }
    contract(nl);
  }

  // ---- epilogue: the denominators (each warp's share, summed in a fixed
  // order), the statistics (once a row: from the blocks of column tile 0,
  // dmin and the threshold from head group 0's), the normalised output
#pragma unroll
  for (int h = 0; h < HB; ++h) sm.dpart[warp][h][lane] = dacc[h];
  __syncthreads();
  for (int e = tid; e < HB * TM; e += THREADS) {
    const int h = e / TM, o = e - h * TM;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += sm.dpart[w][h][o];
    const float rd = 1.f / fmaxf(s, 1e-30f);
    sm.rden[h][o] = rd;
    const int i = o0 + o;
    if (a.stats != nullptr && ct == 0 && i < Lo) {
      float* st = a.stats + (size_t)b * (H + 2) * Lo + i;
      if (h0 + h < H) st[(size_t)(2 + h0 + h) * Lo] = rd;
      if (grp == 0 && h == 0) { st[0] = sm.odmin[o]; st[Lo] = sm.othr[o]; }
    }
  }
  __syncthreads();
  if (!head_ok) return;  // warp-uniform; no block barrier follows
  const int rows[8] = {og * 4, og * 4 + 1, og * 4 + 2, og * 4 + 3,
                       16 + og * 4, 16 + og * 4 + 1, 16 + og * 4 + 2, 16 + og * 4 + 3};
  const int cols[8] = {cg * 4, cg * 4 + 1, cg * 4 + 2, cg * 4 + 3,
                       32 + cg * 4, 32 + cg * 4 + 1, 32 + cg * 4 + 2, 32 + cg * 4 + 3};
  const int c0 = col0 + slab * TN;  // the warp's first column
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = o0 + rows[r];
    if (i >= Lo) continue;
    const float rd = sm.rden[wh][rows[r]];
    float* dst = a.out + ((size_t)b * Lo + i) * H * D + (size_t)(h0 + wh) * D + c0;
    if (a.vec4) {  // 16-byte stores: a warp writes four whole 128-byte rows
#pragma unroll
      for (int c = 0; c < 8; c += 4)
        if (c0 + cols[c] < D) st4(dst + cols[c], acc[r] + c, rd);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + cols[c] < D) dst[cols[c]] = acc[r][c] * rd;
    }
  }
}

template <int HB, int NS>
int launch_shape(const Args& a, int B, cudaStream_t s) {
  using S = Shape<HB, NS>;
  constexpr int smem = (int)sizeof(Smem<HB, NS>);
  int rc = (int)cudaFuncSetAttribute(fwd_kernel<HB, NS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int n_ct = (a.D + S::CW - 1) / S::CW;
  const dim3 grid((a.H + HB - 1) / HB * n_ct, (a.Lo + TM - 1) / TM, B);
  fwd_kernel<HB, NS><<<grid, S::THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// a warp per head and 64-column slab: two slabs a head (128 columns) at
// one or two heads, four at one head; one slab a head above two heads
template <int HB>
int launch(const Args& a, int B, cudaStream_t s) {
  const int slabs = (a.D + TN - 1) / TN;
  if constexpr (HB == 1)
    if (slabs >= 3) return launch_shape<1, 4>(a, B, s);
  if constexpr (HB <= 2)
    if (slabs >= 2) return launch_shape<HB, 2>(a, B, s);
  return launch_shape<HB, 1>(a, B, s);
}

// heads per block: at most 8, in ceil(H/8) groups as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

}  // namespace

extern "C" int posatt_batched_fwd(const float* mq, const float* mk, const float* scale,
                                  const float* u, const float* thr, const int* starts,
                                  float* out, float* stats, int H, int B, int Lo, int Li,
                                  int D, int dd, int keep_count, int width, int tile_rows,
                                  void* stream) {
  // a block of TM rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TM == 0);
  if (H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1 || dd < 1 || dd > MAX_DIM || !tiles_ok ||
      (starts != nullptr && width < 1) || B > 65535 || (Lo + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{mq, mk, scale, u, thr, starts, out, stats,
               H, Lo, Li, D, dd, keep_count, width, tile_rows, (Lo + tile_rows - 1) / tile_rows,
               D % 4 == 0 && reinterpret_cast<size_t>(u) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_group(H)) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 3: return launch<3>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 5: return launch<5>(a, B, s);
    case 6: return launch<6>(a, B, s);
    case 7: return launch<7>(a, B, s);
    default: return launch<8>(a, B, s);
  }
}
