// An ablation of kernel #9 (posatt_tf_fwd, the port's
// position_induced_transformer_torch/kernels/csrc/posatt_tf_fwd.cu) at the
// served elasticity_tf processor only: every column kept (no thr), V 64,
// H a multiple of 4, L_in a multiple of 4. It exports the same C function,
// so scripts/torch_kernel_ablations.py can load it in the kernel's place
// and time it; any other shape returns cudaErrorInvalidValue. It is not
// part of the port.
//
// What it changes against the kernel: pass 2 runs through a producer warp.
// A block has the kernel's four consumer warps (a head each, 32 rows, 64
// value columns) and one more warp that only copies: each step's 32 x 16
// distances and the four heads' 16 value rows (16 x 256 floats) go into a
// three-deep ring in shared memory by the Tensor Memory Accelerator, and
// complete on a "full" mbarrier per slot; each consumer warp waits on it,
// computes its head's weights from the distances itself and contracts, then
// arrives on the slot's "empty" mbarrier, which the producer waits on
// before it refills the slot. No block barrier in the loop, and the
// producer's first copies overlap pass 1 (the row minima). Two forms:
// TENSOR_MAPS, two 2-D box copies a step (cp.async.bulk.tensor over tensor
// maps of the (B*Lo, Li) distances and the (B*Li, H*V) values), or one
// 1-D bulk copy per distance row and per value row (48 a step). The ring
// costs shared memory: two blocks of five warps a SM, against the kernel's
// three of four.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr bool TENSOR_MAPS = true;
constexpr int TM = 32, TK = 16, TN = 64, HG = 4, NBUF = 3;
constexpr int CONSUMERS = HG * 32;
constexpr int THREADS = CONSUMERS + 32;
constexpr int DPAD = TENSOR_MAPS ? 0 : 4;  // a box lands dense; rows copied one by one are padded

struct Smem {
  __align__(128) float v[NBUF][TK][HG * TN];   // the four heads' value rows
  __align__(128) float d[NBUF][TM][TK + DPAD];  // the step's distances, a row each
  __align__(16) float w[2][HG][TK][TM];         // each head's weights
  __align__(8) uint64_t full[NBUF];
  __align__(8) uint64_t empty[NBUF];
  float odmin[TM];
  float rden[HG][TM];
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(saddr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar)) : "memory");
}
// a 2-D box at (x, y) of the tensor map into shared memory
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const float* dist;
  const float* scale;
  const float* values;
  float* out;
  float* stats;
  int Lo, Li, H, V;
};

__global__ void __launch_bounds__(THREADS, 2)
producer_kernel(const Args a, const __grid_constant__ CUtensorMap dmap,
                const __grid_constant__ CUtensorMap vmap) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * HG;
  const int o0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const int Lo = a.Lo, Li = a.Li, HV = a.H * a.V;
  const int nsteps = (Li + TK - 1) / TK;

  // stale ring rows are finite: a short last step reads zeros past L_in
  for (int e = tid; e < NBUF * TK * HG * TN; e += THREADS) (&sm.v[0][0][0])[e] = 0.f;
  for (int e = tid; e < NBUF * TM * (TK + DPAD); e += THREADS) (&sm.d[0][0][0])[e] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], HG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before the copies
  __syncthreads();

  if (warp == HG) {  // ---- the producer
    const int nrows = min(TM, Lo - o0);
    for (int s = 0; s < nsteps; ++s) {
      const int buf = s % NBUF;
      if (s >= NBUF) mbar_wait(&sm.empty[buf], (s / NBUF - 1) & 1);
      const int j0 = s * TK, nk = min(TK, Li - j0);
      if (TENSOR_MAPS) {
        if (lane == 0) {
          // whole boxes, zeros past the tensors' ends
          mbar_expect_tx(&sm.full[buf], (TM * TK + TK * HG * TN) * 4u);
          box_copy(&sm.d[buf][0][0], &dmap, j0, b * Lo + o0, &sm.full[buf]);
          box_copy(&sm.v[buf][0][0], &vmap, h0 * TN, b * Li + j0, &sm.full[buf]);
        }
      } else {
        if (lane == 0) mbar_expect_tx(&sm.full[buf], (unsigned)(nrows * nk + nk * HG * TN) * 4u);
        __syncwarp();
        if (lane < nrows)
          bulk_copy(&sm.d[buf][lane][0], a.dist + ((size_t)b * Lo + o0 + lane) * Li + j0, nk * 4,
                    &sm.full[buf]);
        if (lane < nk)
          bulk_copy(&sm.v[buf][lane][0], a.values + ((size_t)b * Li + j0 + lane) * HV + (size_t)h0 * TN,
                    HG * TN * 4, &sm.full[buf]);
      }
    }
    return;
  }

  // ---- the consumers: pass 1, the bare row minima, a warp per 8 rows
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int i = min(o0 + r, Lo - 1);
    float mn = INFINITY;
    for (int j = lane; j < Li; j += 32) mn = fminf(mn, a.dist[((size_t)b * Lo + i) * Li + j]);
    mn = warp_min(mn);
    if (lane == 0) sm.odmin[r] = mn;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS));

  const int h = h0 + warp;
  const float s = a.scale[h];
  const bool row_ok = o0 + lane < Lo;
  const float dmin = sm.odmin[lane];
  const int og = lane >> 3, cg = lane & 7;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float den = 0.f;

  // this head's weights of step st (its distances in ring slot buf) into
  // weight buffer wb; lane = row. Branch-free (past the last step: zeros),
  // so that the exps can interleave with the products of the step before
  auto weights = [&](int st, int buf, int wb, bool on) {
    const int j0 = st * TK;
#pragma unroll
    for (int k4 = 0; k4 < TK; k4 += 4) {
      float d[4];
      lds4(&sm.d[buf][lane][k4], d);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool kept = on && row_ok && j0 + k4 + q < Li;
        const float e = expf(-fmaxf(__fsub_rn(d[q], dmin), 0.f) * s);
        const float p = kept ? e : 0.f;
        den += p;
        sm.w[wb][warp][k4 + q][lane] = p;
      }
    }
  };

  mbar_wait(&sm.full[0], 0);
  weights(0, 0, 0, true);
  __syncwarp();
  for (int st = 0; st < nsteps; ++st) {
    const int buf = st % NBUF, wb = st & 1;
    const bool more = st + 1 < nsteps;
    if (more) mbar_wait(&sm.full[(st + 1) % NBUF], ((st + 1) / NBUF) & 1);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float wv[8], vv[8];
      lds4(&sm.w[wb][warp][k][og * 4], wv);
      lds4(&sm.w[wb][warp][k][16 + og * 4], wv + 4);
      lds4(&sm.v[buf][k][warp * TN + cg * 4], vv);
      lds4(&sm.v[buf][k][warp * TN + 32 + cg * 4], vv + 4);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);
    }
    weights(st + 1, (st + 1) % NBUF, wb ^ 1, more);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[buf]);
  }

  // ---- epilogue, as the kernel's
  const float rden = 1.f / fmaxf(den, 1e-30f);
  sm.rden[warp][lane] = rden;
  __syncwarp();
  if (a.stats != nullptr && row_ok) {
    float* st = a.stats + (size_t)b * (a.H + 2) * Lo + o0 + lane;
    st[(size_t)(2 + h) * Lo] = rden;
    if (h == 0) { st[0] = dmin; st[Lo] = INFINITY; }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = (r < 4 ? 0 : 16) + og * 4 + (r & 3);
    const int i = o0 + row;
    if (i >= Lo) continue;
    const float rd = sm.rden[warp][row];
    float* dst = a.out + ((size_t)b * Lo + i) * HV + (size_t)h * a.V;
    *reinterpret_cast<float4*>(dst + cg * 4) =
        make_float4(acc[r][0] * rd, acc[r][1] * rd, acc[r][2] * rd, acc[r][3] * rd);
    *reinterpret_cast<float4*>(dst + 32 + cg * 4) =
        make_float4(acc[r][4] * rd, acc[r][5] * rd, acc[r][6] * rd, acc[r][7] * rd);
  }
}

// a 2-D tensor map of a row-major (rows, cols) float32 tensor, box (box_rows, box_cols)
int tensor_map(CUtensorMap* map, const float* base, int rows, int cols, int box_rows, int box_cols) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const int rc = (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                reinterpret_cast<void**>(&encode),
                                                cudaEnableDefault, &q);
    if (rc != 0 || q != cudaDriverEntryPointSuccess) return rc != 0 ? rc : (int)cudaErrorUnknown;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int posatt_tf_fwd(const float* dist, const float* thr, const float* scale,
                             const float* values, float* out, float* stats, int B, int Lo,
                             int Li, int H, int V, void* stream) {
  if (thr != nullptr || V != TN || H % HG != 0 || Li % 4 != 0 ||
      reinterpret_cast<size_t>(dist) % 16 != 0 || reinterpret_cast<size_t>(values) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap dmap{}, vmap{};
  if (TENSOR_MAPS) {
    int rc = tensor_map(&dmap, dist, B * Lo, Li, TM, TK);
    if (rc == 0) rc = tensor_map(&vmap, values, B * Li, H * V, TK, HG * TN);
    if (rc != 0) return rc;
  }
  constexpr int smem = (int)sizeof(Smem);
  int rc = (int)cudaFuncSetAttribute(producer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem);
  if (rc != 0) return rc;
  const Args a{dist, scale, values, out, stats, Lo, Li, H, V};
  const dim3 grid(H / HG, (Lo + TM - 1) / TM, B);
  producer_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, dmap, vmap);
  return (int)cudaGetLastError();
}
