// Fixed-mesh TF-semantics position attention, forward pass (#13),
// hand-written for Hopper (sm_90a), float32 throughout. Two C entry points:
//
//   posatt_tf_fixed_plan  the pre-pass: each head's row statistics m and l
//                         and, for a local op, the kept-step lists
//                         (posatt_tf_fixed.cuh) that the forward, dv and
//                         dscale walk;
//   posatt_tf_fixed_fwd   the forward proper.
//
// Together they replace no Pallas kernel: the JAX package runs this op on
// XLA (position_induced_transformer_tpu/models/pit_tf.py:129-160,
// MultiHeadPosAtt). It is every attention op of the fixed-mesh TF family
// (burgers_tf, sod_tf, darcy_tf, vorticity_tf, naca_tf).
//
// Inputs: dist (Lo, Li), shared by the whole batch; thr (Lo, 2), the
// quantiles at p and 1 - p of each row, or null (global); scale (H), of
// either sign; values (B, Li, H*V), head h's columns at h*V...(h+1)*V.
// Outputs: out (B, Lo, H*V) with
//
//   out[b, i, h*V + c] = sum_j w[h,i,j] values[b, j, h*V + c]
//
// (posatt_tf_fixed.cuh defines w), and stats (H, 2, Lo): m and l of each
// head and row, which the backward entry points read.
//
// What bounds it on this card: 2*B*V operations per kept (head, row,
// column) entry against the distances, values and output: far above the
// f32 ridge of 20 operations per byte at every op of the five
// configurations, so the f32 CUDA-core rate (67 TFLOP/s) bounds it. Tensor
// cores are not used: TF32 would not hold parity with the f32 plain
// version.
//
// Design. A local op keeps a few per cent of a row for a head of scale > 0,
// but a dense body weighs and multiplies every entry; so the kernels walk
// lists of the 16-wide steps that hold a kept entry.
// - plan: scan_kernel reads each row twice for up to 8 heads at once (a
//   warp a row): m and a bitmap of the 16 x 16 blocks that keep an entry,
//   then l in the plain softmax's order; lists_kernel turns the bitmap into
//   the lists, ascending, cut to the forward's and dv's tiles.
// - fwd_kernel: the product W_h (Lo x Li) times head h's values, taken as a
//   (Li, B*V) matrix: a block owns 128 rows (64 or 32 where 128-row blocks
//   would leave SMs idle), one head and a column tile of up to 8 samples by
//   128 / 8 value columns, and walks its row tile's list of 16-column steps
//   only (an unlisted step's weights are all 0: skipping it changes no bit
//   of the sums). A ring of three shared-memory stages filled by cp.async
//   keeps the next steps' distances and values in flight while the block
//   computes one step's weights once (transposed into a double-buffered
//   tile; each weight rounded as the plain softmax rounds it) and adds 8 x
//   8 (or 4 x 8, 2 x 8) products a thread from float4 reads of each
//   operand; one barrier a step. A launch of few blocks splits the
//   reduction into ranges of 512 or more columns, each block walking the
//   listed steps of its range, summed in order by sum_splits: the same
//   bits on every run.
//
// The entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() after the launches.

#include "posatt_tf_fixed.cuh"

namespace {

using namespace tffixed;

// A warp a row, for up to MAXH heads a pass over the row: the first pass
// finds each head's m and the 16 x 16 blocks that keep an entry (a ballot a
// 32 columns; atomicOr into the bitmap: exact in any order), the second
// sums l. Lane j % 32 takes columns j, j + 32, ... in order and the lanes
// combine in a butterfly: the order of the plain version's softmax for a
// row of up to 1024 columns (a warp a row), so that l, and with it each
// weight exp(m - s*d) / l, has its bits; the same bits on every run.
__global__ void __launch_bounds__(THREADS) scan_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    float* __restrict__ stats, unsigned* __restrict__ bits, int Lo, int Li, int H, int mode,
    int nU, int nW) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (i >= Lo) return;  // a whole warp
  const float* row = dist + (size_t)i * Li;
  for (int h0 = 0; h0 < H; h0 += MAXH) {
    const int nh = min(MAXH, H - h0);
    float s[MAXH], t[MAXH], m[MAXH];
    unsigned word[MAXH];
#pragma unroll
    for (int q = 0; q < MAXH; ++q) {
      s[q] = q < nh ? scale[h0 + q] : 0.f;
      t[q] = q < nh ? keep_threshold(thr, i, s[q], mode) : 0.f;
      m[q] = INFINITY;
      word[q] = 0u;
    }
    for (int base = 0; base < Li; base += 32) {
      const int j = base + lane;
      const float d = j < Li ? row[j] : 0.f;
      const int blk = base / SW;  // the 16-column blocks blk and blk + 1
#pragma unroll
      for (int q = 0; q < MAXH; ++q) {
        if (q >= nh) break;
        const float sd = __fmul_rn(s[q], d);
        const bool k = j < Li && kept(d, sd, t[q], mode);
        if (k) m[q] = fminf(m[q], sd);
        if (bits != nullptr) {
          const unsigned mask = __ballot_sync(0xffffffffu, k);
          word[q] |= ((mask & 0xffffu) ? 1u << (blk % 32) : 0u) |
                     ((mask >> 16) ? 1u << ((blk + 1) % 32) : 0u);
          if ((blk + 2) % 32 == 0 || base + 32 >= Li) {
            if (lane == 0 && word[q] != 0u)
              atomicOr(&bits[((size_t)(h0 + q) * nU + i / SW) * nW + blk / 32], word[q]);
            word[q] = 0u;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < MAXH; ++q) {
      if (q >= nh) break;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m[q] = fminf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
    }
#pragma unroll
    for (int q = 0; q < MAXH; ++q) {
      if (q >= nh) break;
      float l = (float)Li;
      if (!isinf(m[q])) {
        l = 0.f;
        for (int j = lane; j < Li; j += 32) {
          const float d = row[j], sd = __fmul_rn(s[q], d);
          if (kept(d, sd, t[q], mode)) l += expf(__fsub_rn(m[q], sd));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      }
      if (lane == 0) {
        stats[(size_t)(2 * (h0 + q)) * Lo + i] = m[q];
        stats[(size_t)(2 * (h0 + q) + 1) * Lo + i] = l;
      }
    }
  }
}

// exclusive prefix sum of v over the block; *total gets the sum
__device__ __forceinline__ int block_scan(int v, int* total, int* buf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < THREADS / 32 ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < THREADS / 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane < THREADS / 32) buf[lane] = y;
  }
  __syncthreads();
  const int before = warp ? buf[warp - 1] : 0;
  *total = buf[THREADS / 32 - 1];
  __syncthreads();  // buf is reused by the next call
  return before + x - v;
}

__device__ __forceinline__ bool empty_row(const float* stats, int h, int i, int Lo) {
  return i < Lo && isinf(stats[(size_t)(2 * h) * Lo + i]);
}

// blocks [0, H*nF): the forward lists of FT-row tiles; [H*nF, H*(nF+nD)):
// the dv lists of DT-column tiles; then H*nJ blocks: the 128 x 128 tile
// flags of one 128-column tile (FT, DT = 128, 64 or 32)
__global__ void __launch_bounds__(THREADS) lists_kernel(
    const unsigned* __restrict__ bits, const float* __restrict__ stats, int* __restrict__ fwd_idx,
    int* __restrict__ fwd_cnt, int* __restrict__ dv_idx, int* __restrict__ dv_cnt,
    int* __restrict__ tiles, int Lo, int Li, int H, int FT, int DT) {
  __shared__ int buf[THREADS / 32];
  const int nU = cdiv(Lo, SW), nT = cdiv(Li, SW), nW = cdiv(nT, 32);
  const int nF = cdiv(Lo, FT), nD = cdiv(Li, DT), nI = cdiv(Lo, BM), nJ = cdiv(Li, BM);
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < H * nF) {
    const int h = blk / nF, I = blk % nF;
    const int full = __syncthreads_or(tid < FT && empty_row(stats, h, I * FT + tid, Lo));
    int* idx = fwd_idx + (size_t)blk * nT;
    const int u0 = I * (FT / SW), u1 = min(nU, u0 + FT / SW);
    int carry = 0;
    for (int w0 = 0; w0 < nW; w0 += THREADS) {
      const int w = w0 + tid;
      unsigned word = 0u;
      if (w < nW) {
        if (full) {
          word = ~0u;
        } else {
          for (int u = u0; u < u1; ++u) word |= bits[((size_t)h * nU + u) * nW + w];
        }
        const int left = nT - 32 * w;
        if (left < 32) word &= (1u << left) - 1u;
      }
      int total;
      int p = carry + block_scan(__popc(word), &total, buf);
      while (word) {
        idx[p++] = 32 * w + __ffs(word) - 1;
        word &= word - 1u;
      }
      carry += total;
    }
    for (int p = carry + tid; p < nT; p += THREADS) idx[p] = -1;
    if (tid == 0) fwd_cnt[blk] = carry;
    return;
  }
  blk -= H * nF;
  if (blk < H * nD) {
    const int h = blk / nD, J = blk % nD, t0 = J * (DT / SW);  // its first 16-column block
    const unsigned mask = ((1u << (DT / SW)) - 1u) << (t0 % 32);
    const unsigned* col = bits + (size_t)h * nU * nW + t0 / 32;  // that word of each row block
    int* idx = dv_idx + (size_t)blk * nU;
    int carry = 0;
    for (int v0 = 0; v0 < nU; v0 += THREADS) {
      const int u = v0 + tid;
      int flag = 0;
      if (u < nU) {
        flag = (col[(size_t)u * nW] & mask) != 0u;
        for (int r = 0; r < SW && !flag; ++r) flag = empty_row(stats, h, u * SW + r, Lo);
      }
      int total;
      const int p = carry + block_scan(flag, &total, buf);
      if (flag) idx[p] = u;
      carry += total;
    }
    for (int p = carry + tid; p < nU; p += THREADS) idx[p] = -1;
    if (tid == 0) dv_cnt[blk] = carry;
    return;
  }
  blk -= H * nD;
  const int h = blk / nJ, J = blk % nJ, sh = 8 * (J % 4);
  const unsigned* col = bits + (size_t)h * nU * nW + J / 4;
  for (int I = tid; I < nI; I += THREADS) {
    unsigned any = 0u;
    for (int u = I * (BM / SW); u < min(nU, (I + 1) * (BM / SW)); ++u)
      any |= (col[(size_t)u * nW] >> sh) & 0xffu;
    tiles[((size_t)h * nI + I) * nJ + J] = any != 0u;
  }
}

constexpr int DP = SW + 4;  // a staged distance row: 16 columns, padded (float4 reads)

template <int BMT>
constexpr int fwd_smem() {  // distances, values, two weight tiles, the rows' t, m, l, 1 / l
  return (STAGES * BMT * DP + STAGES * SW * BN + 2 * SW * (BMT + 4) + 4 * BMT) * 4;
}

// A block of BMT = 128, 64 or 32 rows (16 * RT: RT rows a thread) walks
// its row tile's list (the plan's lists are cut to the same tiles).
template <int BMT>
__global__ void __launch_bounds__(THREADS, 2) fwd_kernel(
    const float* __restrict__ dist, const float* __restrict__ thr, const float* __restrict__ scale,
    const float* __restrict__ values, const float* __restrict__ stats,
    const int* __restrict__ list_idx, const int* __restrict__ list_cnt, float* __restrict__ out,
    int B, int Lo, int Li, int H, int V, int mode, int BT, int CW, int nct, int nT, int chunk,
    int vecd, int vecv) {
  constexpr int RT = BMT / 16, WP = BMT + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ds = smem;                     // STAGES x BMT x DP: distances, row-major
  float* Vs = Ds + STAGES * BMT * DP;   // STAGES x SW x BN: value rows
  float* Ws = Vs + STAGES * SW * BN;    // 2 x SW x WP: weights, depth first
  float* Rw = Ws + 2 * SW * WP;         // 4 x BMT: the rows' t, m, l and 1 / l
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BMT, h = blockIdx.z % H, split = blockIdx.z / H;
  const Cols cols = cols_of(blockIdx.y, BT, CW, nct);
  const int HV = H * V;
  const float s = scale[h];
  out += (size_t)split * B * Lo * HV;  // this split's partial sums
  if (tid < BMT) {
    const int i = i0 + tid;
    const bool ok = i < Lo;
    const float l = ok ? stats[(size_t)(2 * h + 1) * Lo + i] : 1.f;
    Rw[tid] = ok ? keep_threshold(thr, i, s, mode) : 0.f;
    Rw[BMT + tid] = ok ? stats[(size_t)(2 * h) * Lo + i] : 0.f;
    Rw[2 * BMT + tid] = l;
    Rw[3 * BMT + tid] = __frcp_rn(l);
  }

  const size_t tile = (size_t)h * gridDim.x + blockIdx.x;
  const int* lst = list_idx ? list_idx + tile * nT : nullptr;
  const int cnt = list_idx ? list_cnt[tile] : nT;
  int beg, end;
  split_range(lst, cnt, split, chunk, &beg, &end);
  const int n = end - beg;
  auto step = [&](int p) { return lst ? __ldg(lst + beg + p) : beg + p; };

  const ColStage cs = stage_cols(cols, values, B, Li, H, V, h, vecv, tid);
  auto load = [&](int t, int slot) {
    const int j0 = t * SW;
    float* D = Ds + slot * BMT * DP;
    if (vecd) {
#pragma unroll
      for (int q = 0; q < cdiv(BMT * SW / 4, THREADS); ++q) {
        const int e = tid + q * THREADS, row = e / (SW / 4), c = 4 * (e % (SW / 4));
        const int ii = i0 + row, j = j0 + c;
        const bool ok = ii < Lo && j < Li;
        if (BMT * SW / 4 >= THREADS || e < BMT * SW / 4)
          cp16(D + row * DP + c, ok ? dist + (size_t)ii * Li + j : dist, ok);
      }
    } else {  // a warp copies two rows' 16 columns a copy: coalesced
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int row = tid / SW + q * (THREADS / SW), c = tid % SW;
        const int ii = i0 + row, j = j0 + c;
        const bool ok = ii < Lo && j < Li;
        cp4(D + row * DP + c, ok ? dist + (size_t)ii * Li + j : dist, ok);
      }
    }
    load_cols(Vs + slot * SW * BN, cs, j0, Li, HV, vecv);
  };
  // the weights of step t (in stage `slot`) into weight buffer wb: row r,
  // RT adjacent columns
  const int r = tid % BMT, part = tid / BMT;
  auto weigh = [&](int t, int slot, int wb) {
    const float* D = Ds + slot * BMT * DP + r * DP + part * RT;
    float d[RT];
    if (RT == 8) {
      lds4(D, d);
      lds4(D + 4, d + 4);
    } else if (RT == 4) {
      lds4(D, d);
    } else {
      lds_rows<2>(D, 0, d);
    }
    const float tr = Rw[r], mr = Rw[BMT + r], lr = Rw[2 * BMT + r], rlr = Rw[3 * BMT + r];
    float* W = Ws + wb * SW * WP + (part * RT) * WP + r;
    const int j = t * SW + part * RT;
    const bool rok = i0 + r < Lo;
#pragma unroll
    for (int e = 0; e < RT; ++e)
      W[e * WP] = (rok && j + e < Li) ? weight(d[e], s, tr, mr, lr, rlr, mode) : 0.f;
  };

  float acc[RT][8];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
  }
  // steps k (weighed), k + 1 (landing) and k + 2 (in flight)
  int t1 = n > 1 ? step(1) : 0, t2 = n > 2 ? step(2) : 0;
  if (n > 0) load(step(0), 0);
  cp_commit();
  if (n > 1) load(t1, 1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  if (n > 0) weigh(step(0), 0, 0);
  for (int k = 0; k < n; ++k) {
    cp_wait<0>();
    __syncthreads();
    if (k + 2 < n) load(t2, (k + 2) % STAGES);
    cp_commit();
    const int t3 = k + 3 < n ? step(k + 3) : 0;
    if (k + 1 < n) weigh(t1, (k + 1) % STAGES, (k + 1) % 2);
    step_product<RT, WP, BN>(Ws + (k % 2) * SW * WP, Vs + (k % STAGES) * SW * BN, tx, ty, acc);
    t1 = t2;
    t2 = t3;
  }
  store_tile<RT>(out, acc, cols, i0, Lo, B, H, V, h, tx, ty, vecv);
}

template <int BMT>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* dist, const float* thr,
                       const float* scale, const float* values, const float* stats,
                       const int* fwd_idx, const int* fwd_cnt, float* out, int B, int Lo, int Li,
                       int H, int V, int mode, const ColPlan& p, int chunk, int vecd, int vecv) {
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<BMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_smem<BMT>());
  if (err != cudaSuccess) return err;
  fwd_kernel<BMT><<<grid, THREADS, fwd_smem<BMT>(), st>>>(
      dist, thr, scale, values, stats, fwd_idx, fwd_cnt, out, B, Lo, Li, H, V, mode, p.BT, p.CW,
      p.nct, cdiv(Li, SW), chunk, vecd, vecv);
  return cudaGetLastError();
}

}  // namespace

// stats (H, 2, Lo); with thr, also the lists: bits (H, nU, nW) scratch,
// fwd_idx (H, nF, nT), fwd_cnt (H, nF), dv_idx (H, nD, nU), dv_cnt (H, nD),
// tiles (H, nI, nJ), nU = ceil(Lo / 16), nT = ceil(Li / 16), nW = ceil(nT /
// 32), nF = ceil(Lo / ft), nD = ceil(Li / dt), nI = ceil(Lo / 128), nJ =
// ceil(Li / 128): ft and dt the forward's and dv's tiles (128, 64 or 32)
extern "C" int posatt_tf_fixed_plan(const float* dist, const float* thr, const float* scale,
                                    float* stats, unsigned* bits, int* fwd_idx, int* fwd_cnt,
                                    int* dv_idx, int* dv_cnt, int* tiles, int Lo, int Li, int H,
                                    int mode, int ft, int dt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ft != 128 && ft != 64 && ft != 32) || (dt != 128 && dt != 64 && dt != 32))
    return cudaErrorInvalidValue;
  const int nU = cdiv(Lo, SW), nT = cdiv(Li, SW), nW = cdiv(nT, 32);
  const bool lists = thr != nullptr;
  cudaError_t err;
  if (lists) {
    err = cudaMemsetAsync(bits, 0, (size_t)H * nU * nW * sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
  }
  const int rows_per_block = THREADS / 32;
  scan_kernel<<<cdiv(Lo, rows_per_block), THREADS, 0, st>>>(
      dist, thr, scale, stats, lists ? bits : nullptr, Lo, Li, H, mode, nU, nW);
  err = cudaGetLastError();
  if (err != cudaSuccess || !lists) return err;
  lists_kernel<<<H * (cdiv(Lo, ft) + cdiv(Li, dt) + cdiv(Li, BM)), THREADS, 0, st>>>(
      bits, stats, fwd_idx, fwd_cnt, dv_idx, dv_cnt, tiles, Lo, Li, H, ft, dt);
  return cudaGetLastError();
}

// fwd_idx, fwd_cnt: the plan's forward lists, or null (a global op: every
// step); bm: rows a block (128, 64 or 32); the reduction is cut into
// `splits` ranges of `chunk` 16-column steps; part: scratch of (splits, B,
// Lo, H*V) floats where splits > 1, else null; vecd: dist's rows 16-byte
// aligned; vecv: value columns in aligned fours (V and the column tile's
// width multiples of 4)
extern "C" int posatt_tf_fixed_fwd(const float* dist, const float* thr, const float* scale,
                                   const float* values, const float* stats, const int* fwd_idx,
                                   const int* fwd_cnt, float* out, float* part, int B, int Lo,
                                   int Li, int H, int V, int mode, int bm, int splits, int chunk,
                                   int vecd, int vecv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ColPlan p = col_plan(B, V);
  dim3 grid(cdiv(Lo, bm), p.tiles, H * splits);
  float* dst = splits > 1 ? part : out;
  cudaError_t err;
  if (bm == 128)
    err = launch_fwd<128>(grid, st, dist, thr, scale, values, stats, fwd_idx, fwd_cnt, dst, B, Lo,
                          Li, H, V, mode, p, chunk, vecd, vecv);
  else if (bm == 64)
    err = launch_fwd<64>(grid, st, dist, thr, scale, values, stats, fwd_idx, fwd_cnt, dst, B, Lo,
                         Li, H, V, mode, p, chunk, vecd, vecv);
  else if (bm == 32)
    err = launch_fwd<32>(grid, st, dist, thr, scale, values, stats, fwd_idx, fwd_cnt, dst, B, Lo,
                         Li, H, V, mode, p, chunk, vecd, vecv);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, out, (size_t)B * Lo * H * V, splits, st);
}
