// TF-semantics position attention, forward pass, hand-written for Hopper
// (sm_90a), float32 throughout. Two C entry points, one per TPU kernel:
//
//   posatt_tf_fwd        replaces _make_tf_fwd_kernel, launched by
//                        _posatt_tf_raw (pallas_call at
//                        position_induced_transformer_tpu/kernels/
//                        posatt_batched.py:733): pre-built distances
//                        dist (B, Lo, Li);
//   posatt_tf_coord_fwd  replaces _make_tf_coord_fwd_kernel, launched by
//                        _posatt_tf_coord_raw (pallas_call at :1175):
//                        distances from coordinates mq (B, Lo, dd) and mk
//                        (B, Li, dd) on the extended key axis, with an
//                        optional band (starts, width, tile_rows).
//
// For sample b, output row i, head h and value column k of head h, over the
// row's column window W (the whole key axis, or the band [start, start +
// width) clipped to it, start = starts[b, i / tile_rows]):
//
//   d[i,j]   = dist[b,i,j], or sum_c (q[i,c] - k[j,c])^2 (diff, square, sum
//              in c order; the caller folds the TF halving into the scale
//              and the thresholds)
//   keep     = j in W and d <= thr[b,i] (every column of W without thr)
//   dmin[i]  = min over W of d (the bare minimum)
//   p[h,i,j] = keep ? exp(-(d - dmin) * scale[h]) : 0
//   out[b, i, h*V + k] = sum_j p values[b, j, h*V + k] / max(sum_j p, 1e-30)
//
// Values are per head: head h reads only its own V columns. With a non-null
// `stats` the kernels also write, per row, dmin, the keep threshold (+inf
// without thr) and per head the reciprocal denominator, (B, H + 2, Lo): the
// residuals of the backward kernels in posatt_tf_bwd.cu.
//
// What bounds them on this card: 2*V operations per kept entry and head
// (2*H*V in all), plus 3*dd per distance inspected when they compute them,
// against inputs of the coordinates (or the (B, Lo, Li) distances), the
// values and the (B, Lo, H*V) output. At the elasticity_tf processor (every
// entry of a 972 x 972 window kept, H*V = 512) that is far above the f32
// ridge of 20 operations per byte, so the f32 CUDA-core rate bounds it,
// about 0.144 ms a launch; the banded encoder and decoder keep about 20
// columns a row of a 384-column window and bytes bound them. With
// pre-built distances the 37.8 MB a batch of them takes at L = 972 bounds a
// thresholded op.
//
// Both entry points run one body, tf_kernel, templated on where the
// distances come from (the design of posatt_tf_bwd.cu's TF backward):
// - A block owns 32 rows of one sample, a group of HG heads (a warp each;
//   HG = 1, 2 or 4, groups of four above four heads) and 64 value columns
//   of each. It reads or computes each (i, j) distance of its window once
//   for all its heads: read from dist, or computed in the op order above
//   (__fsub_rn / __fmul_rn / __fadd_rn, no FMA contraction), so the kept
//   sets and dmin are bit for bit ops/distances.euclidean_sq's; each warp
//   computes its head's weight once per kept entry.
// - Pass 1 scans the window once: per row the bare minimum, and from the
//   same distances a compacted, ordered list of the columns that any of
//   the block's rows keeps (warp ballots in shared memory, refilled in
//   rounds when a window keeps more than LCAP columns). The window's
//   distances are not staged (32 x 972 x 4 B = 124 KB at the processor
//   would leave one block a SM); pass 2 reads (from L2: 37.8 MB of them at
//   the served elasticity_tf batch) or recomputes the listed ones.
// - Pass 2 contracts over the list only: with angle-sorted clouds a 32-row
//   tile keeps a few dozen of its window's columns. Register tiles of 8 x 8
//   outputs per lane, read from shared memory as conflict-free float4s (64
//   FMAs per four 16-byte loads); one block barrier a step, and while step
//   s is contracted, step s + 1's value rows are in flight (cp.async,
//   16-byte pieces where V % 4 == 0) and its weights are computed,
//   branch-free so that the exps interleave with the products. From
//   coordinates, all the block's threads compute step s + 2's x = d - dmin
//   into a tile its head warps share. From pre-built distances, the block
//   stages step s + 2's 32 x 16 distances into shared memory by cp.async
//   (row-wise: 16-byte pieces where the step's listed columns run
//   contiguously, as at the processor, else a column a copy) and each
//   head warp weights its entries from them: no x tile and no distance held
//   in registers, which PERF.md finds faster at the processor.
// - The normalisation is deferred to the output, as the TPU kernels do; the
//   denominators are summed beside the products, one lane a row. Sums in
//   fixed orders: the same bits on every run.
// - About 60 KB of dynamic shared memory a block of four warps, three
//   blocks a SM at up to 168 registers a thread. A producer warp feeding a
//   ring by tensor-map copies, with mbarriers in place of the barrier, was
//   timed as an ablation (scripts/torch_kernel_ablations.py) and not kept.
// Tensor cores are not used: TF32 would not hold parity with the f32 oracle.
// Rows, window columns past the key axis and value columns past V are
// masked by index (the TPU kernels pad instead).
//
// Each function launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_DIM = 4;  // coordinates per point

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

constexpr int TM = 32;      // rows a block
constexpr int TK = 16;      // listed columns a step
constexpr int TN = 64;      // value columns of each head a block
constexpr int LCAP = 1024;  // the compacted list of kept columns
// blocks of four warps resident on an SM: up to 168 registers a thread
constexpr int MIN_BLOCKS = 3;

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

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

struct Args {
  const float* dist;    // (B, Lo, Li): pre-built distances (#9), or null
  const float* mq;      // (B, Lo, dd): coordinates (#11), or null
  const float* mk;      // (B, Li, dd)
  const float* scale;   // (H)
  const float* values;  // (B, Li, H*V)
  const float* thr;     // (B, Lo) or null
  const int* starts;    // (B, n_tiles) or null
  float* out;           // (B, Lo, H*V)
  float* stats;         // (B, H+2, Lo) or null
  int Lo, Li, H, V, dd, width, tile_rows, n_tiles;
  bool vec4;            // value and output rows move in 16-byte pieces (V % 4 == 0, aligned)
  bool dvec4;           // distance rows copy in 16-byte pieces (L_in % 4 == 0, aligned)
};

// What a block keeps in shared memory (dynamic: above the 48 KB of a static
// allocation at four heads). The steps' x, weights and value rows are double
// buffered: step s + 1's weights and value rows and step s + 2's x are
// written while step s's are used.
template <int HG, bool DIST>
struct Smem {
  __align__(16) float v[2][HG][TK][TN];  // each head's value rows
  __align__(16) float w[2][HG][TK][TM];  // each head's weights
  // DIST: a step's distances, a row each; else x = d - dmin of a step's
  // entries, -1 where not kept
  __align__(16) float d[DIST ? 2 : 1][TM][TK + 4];
  float x[DIST ? 1 : 2][TK][TM + 1];
  int list[LCAP];          // the window's columns that a row keeps, in order
  float oq[TM][MAX_DIM];   // the rows' coordinates (from coordinates only)
  float othr[TM];          // the rows' keep thresholds
  float odmin[TM];         // the rows' bare window minima
  float wmin[HG][TM];      // each warp's share of them
  float rden[HG][TM];      // each head's reciprocal denominators
  int cnt[HG];
};

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

// A block: rows o0 = 32*blockIdx.y.. of sample blockIdx.z; head group and
// column tile from blockIdx.x. Warp h owns head h0 + h; lane (og, cg) =
// (lane / 8, lane % 8) owns the rows og*4 + {0..3} and 16 + og*4 + {0..3}
// and the columns cg*4 + {0..3} and 32 + cg*4 + {0..3} of the tile. DIST:
// the distances are read from a.dist (no band), else computed from a.mq and
// a.mk.
template <int HG, bool DIST>
__global__ void __launch_bounds__(HG * 32, MIN_BLOCKS * 4 / HG) tf_kernel(const Args a) {
  constexpr int THREADS = HG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HG, DIST>& sm = *reinterpret_cast<Smem<HG, DIST>*>(smem_raw);

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
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V, dd = a.dd;
  const float s = head_ok ? a.scale[h] : 0.f;
  const float* mkb = DIST ? nullptr : a.mk + (size_t)b * Li * dd;
  // DIST: the block's 32 distance rows; a row past Lo reads row Lo - 1,
  // and keeps nothing
  const float* db = DIST ? a.dist + ((size_t)b * Lo + o0) * Li : nullptr;
  const int olast = Lo - 1 - o0;

  // the block's window, the same for all its rows
  int wb = 0, we = Li;
  if (a.starts != nullptr) {
    const int st = a.starts[(size_t)b * a.n_tiles + o0 / a.tile_rows];
    wb = max(st, 0);
    we = min(st + a.width, Li);
  }
  if (!DIST)
    for (int e = tid; e < TM * MAX_DIM; e += THREADS) {
      const int o = e / MAX_DIM, k = e - o * MAX_DIM;
      const int i = o0 + o;
      sm.oq[o][k] = (i < Lo && k < dd) ? a.mq[((size_t)b * Lo + i) * dd + k] : 0.f;
    }
  for (int o = tid; o < TM; o += THREADS) {
    const int i = o0 + o;
    // a padded row keeps nothing
    sm.othr[o] = i >= Lo ? -INFINITY : (a.thr != nullptr ? a.thr[(size_t)b * Lo + i] : INFINITY);
  }
  __syncthreads();

  // the key coordinates of column c, zeros where !ok (from coordinates only)
  auto key = [&](int c, bool ok, float (&kq)[MAX_DIM]) {
    if constexpr (!DIST) {
#pragma unroll
      for (int k = 0; k < MAX_DIM; ++k) kq[k] = ok && k < dd ? __ldg(mkb + (size_t)c * dd + k) : 0.f;
    }
  };
  // the distance of row o0 + o to column c, whose coordinates are kq
  auto dist_at = [&](int o, int c, const float (&kq)[MAX_DIM]) -> float {
    if constexpr (DIST)
      return __ldg(db + (size_t)min(o, olast) * Li + c);
    else
      return sqdist(sm.oq[o], kq, dd);
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
    for (int w = 0; w < HG; ++w) {
      if (w < warp) off += sm.cnt[w];
      total += sm.cnt[w];
    }
    if (any) sm.list[off + __popc(m & ((1u << lane) - 1u))] = cand;
    __syncthreads();  // the counts are read before the next round writes them
    *n = total;
  };

  // ---- pass 1: each row's bare window minimum and, from the same
  // distances, the list of kept columns; `resume` is the first column
  // whose round did not fit in the list
  int n = 0, resume = we;
  {
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
        const float d = dist_at(o, ok ? c : wb, kq);
        if (ok) {
          mn[o] = fminf(mn[o], d);
          any |= d <= sm.othr[o];
        }
      }
      if (resume == we) {  // block-uniform
        if (n + THREADS <= LCAP)
          append(any, c, &n);
        else
          resume = c0;
      }
    }
    sm.wmin[warp][lane] = warp_min_rows(mn, lane);
  }
  __syncthreads();
  for (int o = tid; o < TM; o += THREADS) {
    float m = sm.wmin[0][o];
#pragma unroll
    for (int w = 1; w < HG; ++w) m = fminf(m, sm.wmin[w][o]);
    sm.odmin[o] = m;
  }
  __syncthreads();

  const int og = lane >> 3, cg = lane & 7;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float den = 0.f;  // the denominator of row o0 + lane, this warp's head
  const float* vsrc = a.values + (size_t)b * Li * HV + (size_t)(head_ok ? h : 0) * a.V + col0;
  const bool c0_ok = col0 + lane < a.V, c1_ok = col0 + lane + 32 < a.V;

  // warp: start copying this head's value rows of step s0 into buffer vb
  auto stage = [&](int s0, int nl, int vb) {
    if (a.vec4) {  // 16 pieces of 4 columns a row
#pragma unroll
      for (int q = 0; q < TK * TN / 4 / 32; ++q) {
        const int e = lane + q * 32;
        const int k = e / (TN / 4), c4 = (e - k * (TN / 4)) * 4;
        const bool ok = s0 + k < nl && col0 + c4 < a.V;
        const float* p = vsrc + (size_t)(s0 + k < nl ? sm.list[s0 + k] : 0) * HV + c4;
        cp_async16(&sm.v[vb][warp][k][c4], ok ? p : vsrc, ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const bool ok = s0 + k < nl;
        const float* p = vsrc + (size_t)(ok ? sm.list[s0 + k] : 0) * HV;
        cp_async4(&sm.v[vb][warp][k][lane], ok && c0_ok ? p + lane : vsrc, ok && c0_ok);
        cp_async4(&sm.v[vb][warp][k][lane + 32], ok && c1_ok ? p + lane + 32 : vsrc,
                  ok && c1_ok);
      }
    }
    cp_async_commit();
  };
  // this warp's products of the step in buffer buf
  auto products = [&](int buf) {
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float wv[8], vv[8];
      lds4(&sm.w[buf][warp][k][og * 4], wv);
      lds4(&sm.w[buf][warp][k][16 + og * 4], wv + 4);
      lds4(&sm.v[buf][warp][k][cg * 4], vv);
      lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
    }
  };

  // ---- pass 2 from coordinates: contract over the listed columns [0, nl),
  // pipelined two deep: while step s is contracted, step s + 1's value rows
  // are in flight and its weights are computed, and step s + 2's x is
  // computed; one block barrier a step.
  // A thread's share of a step's x tile: FILL entries (k, o), k fastest:
  // one listed column a thread
  constexpr int FILL = TK * TM / THREADS;
  const int fk = tid % TK;
  struct Pending {
    float kq[MAX_DIM];  // the column's coordinates
    int c;              // the column; -1 past the list
  };
  // the column's coordinates, loaded a step ahead so that the loads are in
  // flight during a contraction
  auto fill_load = [&](int s0, int nl) {
    Pending p;
    const bool ok = s0 + fk < nl;
    p.c = ok ? sm.list[s0 + fk] : -1;
    key(ok ? p.c : 0, true, p.kq);
    return p;
  };
  // x of a step into buffer xb: d - dmin where kept, else -1
  auto fill_store = [&](const Pending& p, int xb) {
#pragma unroll
    for (int q = 0; q < FILL; ++q) {
      const int o = tid / TK + q * (THREADS / TK);
      float x = -1.f;
      if (p.c >= 0) {  // a listed column is inside the window
        const float d = dist_at(o, p.c, p.kq);
        if (d <= sm.othr[o]) x = __fsub_rn(d, sm.odmin[o]);
      }
      sm.x[xb][fk][o] = x;
    }
  };
  // this head's weights of the step whose x is in buffer xb, into weight
  // buffer xb; lane = row. Branch-free (not kept or past the list: 0), so
  // that the compiler can interleave it with the products of the step before
  auto weights = [&](int xb) {
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float x = sm.x[xb][k][lane];
      const float e = expf(-fmaxf(x, 0.f) * s);
      const float p = x >= 0.f ? e : 0.f;
      den += p;
      sm.w[xb][warp][k][lane] = p;
    }
  };
  auto contract = [&](int nl) {
    if (nl == 0) return;  // block-uniform
    fill_store(fill_load(0, nl), 0);
    fill_store(fill_load(TK, nl), 1);  // past the list: -1
    if (head_ok) stage(0, nl, 0);
    __syncthreads();
    weights(0);
    __syncthreads();  // x of step 0 is read before step 0 writes step 2's
    int buf = 0;
    for (int s0 = 0; s0 < nl; s0 += TK, buf ^= 1) {
      const bool more = s0 + TK < nl;
      const Pending next = fill_load(s0 + 2 * TK, nl);  // nothing past the list
      if (head_ok) {  // warp-uniform
        if (more) stage(s0 + TK, nl, buf ^ 1);
        if (more) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncwarp();
      }
      products(buf);
      weights(buf ^ 1);  // step s + 1's; past the list: zeros, never read
      fill_store(next, buf);
      __syncthreads();  // step s's buffers are free, step s + 1's are visible
    }
  };

  // ---- pass 2 over pre-built distances: the same, with each step's 32 x
  // 16 distances staged row-wise into shared memory by cp.async (16-byte
  // pieces where the step's listed columns run contiguously and aligned, as
  // at the processor; else a listed column a copy), and each warp weighting
  // its head's entries from them; one step in flight, one block barrier a
  // step
  const float othr_l = sm.othr[lane], dmin_l = sm.odmin[lane];
  // the block: start copying the distances of step s0 into buffer dbuf;
  // past the list: zeros, never kept
  auto stage_d = [&](int s0, int nl, int dbuf) {
    const bool run = s0 + TK <= nl && a.dvec4 && sm.list[s0] % 4 == 0 &&
                     sm.list[s0 + TK - 1] - sm.list[s0] == TK - 1;  // block-uniform
    if (run) {
      const int cf = sm.list[s0];
#pragma unroll
      for (int e0 = 0; e0 < TM * TK / 4; e0 += THREADS) {
        const int e = e0 + tid, o = e / (TK / 4), k4 = (e - o * (TK / 4)) * 4;
        if ((TM * TK / 4) % THREADS == 0 || e < TM * TK / 4)  // predicated, no break
          cp_async16(&sm.d[dbuf][o][k4], db + (size_t)min(o, olast) * Li + cf + k4, true);
      }
    } else {
#pragma unroll
      for (int e0 = 0; e0 < TM * TK; e0 += THREADS) {
        const int e = e0 + tid, o = e / TK, k = e - o * TK;
        const bool ok = s0 + k < nl;
        if ((TM * TK) % THREADS == 0 || e < TM * TK)
          cp_async4(&sm.d[dbuf][o][k], ok ? db + (size_t)min(o, olast) * Li + sm.list[s0 + k] : db,
                    ok);
      }
    }
  };
  // this head's weights of the step at s0, its distances in buffer dbuf,
  // into weight buffer wb; lane = row; branch-free as weights()
  auto weights_d = [&](int dbuf, int s0, int nl, int wb) {
#pragma unroll
    for (int k4 = 0; k4 < TK; k4 += 4) {
      float d[4];
      lds4(&sm.d[dbuf][lane][k4], d);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kept = s0 + k4 + q < nl && d[q] <= othr_l;
        const float e = expf(-fmaxf(__fsub_rn(d[q], dmin_l), 0.f) * s);
        const float p = kept ? e : 0.f;
        den += p;
        sm.w[wb][warp][k4 + q][lane] = p;
      }
    }
  };
  auto contract_d = [&](int nl) {
    if (nl == 0) return;  // block-uniform
    stage_d(0, nl, 0);
    stage_d(TK, nl, 1);
    if (head_ok) stage(0, nl, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    weights_d(0, 0, nl, 0);
    __syncthreads();  // step 0's distances are read before step 0 stages step 2's
    int buf = 0;
    for (int s0 = 0; s0 < nl; s0 += TK, buf ^= 1) {
      if (head_ok && s0 + TK < nl) stage(s0 + TK, nl, buf ^ 1);  // warp-uniform
      stage_d(s0 + 2 * TK, nl, buf);
      cp_async_commit();
      products(buf);
      weights_d(buf ^ 1, s0 + TK, nl, buf ^ 1);  // step s + 1's
      cp_async_wait<0>();
      __syncthreads();  // step s's buffers are free, step s + 1's are visible
    }
  };
  auto run = [&](int nl) {
    if constexpr (DIST)
      contract_d(nl);
    else
      contract(nl);
  };

  run(n);
  // the columns whose rounds did not fit in the list, in list-sized rounds
  for (int c0 = resume; c0 < we;) {
    int nl = 0;
    while (c0 < we && nl + THREADS <= LCAP) {
      const int c = c0 + tid;
      bool any = false;
      if (c < we) {
        float kq[MAX_DIM];
        key(c, true, kq);
        for (int o = 0; o < TM && !any; ++o) any = dist_at(o, c, kq) <= sm.othr[o];
      }
      append(any, c, &nl);
      c0 += THREADS;
    }
    run(nl);
  }
  if (!head_ok) return;  // warp-uniform; no block barrier follows

  // ---- epilogue: normalise, write the head's columns and the statistics
  // (once a row: from the blocks of column tile 0, dmin and the threshold
  // from head 0's)
  const float rden = 1.f / fmaxf(den, 1e-30f);
  sm.rden[warp][lane] = rden;
  __syncwarp();
  const int i_own = o0 + lane;
  if (a.stats != nullptr && ct == 0 && i_own < Lo) {
    float* st = a.stats + (size_t)b * (a.H + 2) * Lo + i_own;
    st[(size_t)(2 + h) * Lo] = rden;
    if (h == 0) { st[0] = sm.odmin[lane]; st[Lo] = sm.othr[lane]; }
  }
  const int rows[8] = {og * 4, og * 4 + 1, og * 4 + 2, og * 4 + 3,
                       16 + og * 4, 16 + og * 4 + 1, 16 + og * 4 + 2, 16 + og * 4 + 3};
  const int cols[8] = {cg * 4, cg * 4 + 1, cg * 4 + 2, cg * 4 + 3,
                       32 + cg * 4, 32 + cg * 4 + 1, 32 + cg * 4 + 2, 32 + cg * 4 + 3};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = o0 + rows[r];
    if (i >= Lo) continue;
    const float rd = sm.rden[warp][rows[r]];
    float* dst = a.out + ((size_t)b * Lo + i) * HV + (size_t)h * a.V + col0;
    if (a.vec4) {  // 16-byte stores: a warp writes four whole 128-byte rows
#pragma unroll
      for (int c = 0; c < 8; c += 4)
        if (col0 + cols[c] < a.V) st4(dst + cols[c], acc[r] + c, rd);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (col0 + cols[c] < a.V) dst[cols[c]] = acc[r][c] * rd;
    }
  }
}

// heads a block: 1, 2 or 4 (a warp each), the least power of two that
// holds H up to 4
template <int HG, bool DIST>
int launch_group(const Args& a, int B, cudaStream_t s) {
  constexpr int smem = (int)sizeof(Smem<HG, DIST>);
  int rc = (int)cudaFuncSetAttribute(tf_kernel<HG, DIST>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int n_ct = (a.V + TN - 1) / TN;
  const dim3 grid((a.H + HG - 1) / HG * n_ct, (a.Lo + TM - 1) / TM, B);
  tf_kernel<HG, DIST><<<grid, HG * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool DIST>
int launch(const Args& a, int B, cudaStream_t s) {
  if (a.H == 1) return launch_group<1, DIST>(a, B, s);
  if (a.H == 2) return launch_group<2, DIST>(a, B, s);
  return launch_group<4, DIST>(a, B, s);
}

bool bad_shape(int B, int Lo, int Li, int H, int V) {
  return B < 1 || Lo < 1 || Li < 1 || H < 1 || V < 1 || B > 65535 || (Lo + TM - 1) / TM > 65535;
}

// value and output rows move in 16-byte pieces: V a multiple of 4, both aligned
bool vec4(const float* values, const float* out, int V) {
  return V % 4 == 0 && reinterpret_cast<size_t>(values) % 16 == 0 &&
         reinterpret_cast<size_t>(out) % 16 == 0;
}

}  // namespace

extern "C" int posatt_tf_fwd(const float* dist, const float* thr, const float* scale,
                             const float* values, float* out, float* stats, int B, int Lo,
                             int Li, int H, int V, void* stream) {
  if (bad_shape(B, Lo, Li, H, V)) return (int)cudaErrorInvalidValue;
  // no band: the window is the whole key axis
  const Args a{dist, nullptr, nullptr, scale, values, thr, nullptr, out, stats,
               Lo, Li, H, V, 0, 0, Lo, 1, vec4(values, out, V),
               Li % 4 == 0 && reinterpret_cast<size_t>(dist) % 16 == 0};
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}

extern "C" int posatt_tf_coord_fwd(const float* mq, const float* mk, const float* scale,
                                   const float* values, const float* thr, const int* starts,
                                   float* out, float* stats, int B, int Lo, int Li, int H,
                                   int V, int dd, int width, int tile_rows, void* stream) {
  // a block of 32 rows must stay inside one band tile
  const bool tiles_ok = tile_rows >= Lo || (tile_rows > 0 && tile_rows % TM == 0);
  if (bad_shape(B, Lo, Li, H, V) || dd < 1 || dd > MAX_DIM || !tiles_ok ||
      (starts != nullptr && width < 1))
    return (int)cudaErrorInvalidValue;
  const Args a{nullptr, mq, mk, scale, values, thr, starts, out, stats,
               Lo, Li, H, V, dd, width, tile_rows, (Lo + tile_rows - 1) / tile_rows,
               vec4(values, out, V), false};
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}
