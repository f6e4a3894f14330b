// What the fixed-mesh kernels share: the keep rule, warp and cp.async
// helpers, and the one rule that cuts every fixed-mesh launch
// (posatt_fixed_fwd.cu's forward and row statistics, posatt_fixed_bwd.cu's
// dscale and du) into blocks and splits of its streamed index.
//
// A block owns TM = 32 "owned" indices (the forward, stats and dscale: rows
// i; du: keys j), a tile of 64-column slabs of the batch-folded values (the
// forward's version 1: of one sample's D columns) and one split of the
// streamed index (keys j, or du's rows i). The streamed
// index is dealt to the splits in groups of GROUP, in turn, so that the
// band of a masked shape is shared by all splits; the split count aims at
// about 8 warps on each of the card's 132 SMs.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG = -1e38f;  // a masked logit: finite, so no inf - inf
constexpr unsigned FULL = 0xffffffffu;

constexpr int TM = 32;   // owned indices a block
constexpr int TN = 64;   // value columns a warp
constexpr int SK = 16;   // staged rows a contraction step
constexpr int SM_WARPS = 12;        // resident warps a SM the register cap allows
constexpr int TARGET_WARPS = 1056;  // the split aims at 8 warps on each of 132 SMs
// a row walk's split aims at twice as many: its one-warp blocks wait on
// their loads, and hold little shared memory
constexpr int WALK_WARPS = 2 * TARGET_WARPS;
constexpr int WALK_COLS = 32;       // the widest tile a row walk always takes
constexpr int KEY_WARPS = 4;        // warps of a one-slab block of versions 1 and 2
constexpr int MAX_SPLITS = 32;      // splits of a streamed index
constexpr int MAX_CLUSTER = 8;      // splits that form one cluster of blocks (portable size)
constexpr int GROUP = 16;           // the streamed indices are dealt to the splits in groups

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ bool kept(float d, float thr) {
  return (d <= thr) && (d < INFINITY);
}

__device__ __forceinline__ float logit(float d, float thr, float s) {
  return kept(d, thr) ? -s * d : NEG;
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

// all but the last committed group
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// heads a block (or a group of du's steps): at most 8, in ceil(H/8) groups
// as even as can be
int head_group(int H) {
  const int groups = (H + 7) / 8;
  return (H + groups - 1) / groups;
}

enum Kind { DSCALE = 0, DU = 1, FWD = 2 };

// How a launch cuts its work: heads and 64-column slabs a block, column
// tiles, owned tiles, head groups, the split of the streamed index and the
// local streamed indices a split (R, a multiple of GROUP).
struct Plan {
  int hb, ns, n_ct, tiles, groups, splits, R;
  int walk;  // versions 1 and 2 at one 64-column slab or less: a row walk over
             // a tile of 4, 16, 32 or 64 columns (0: the rounds of the list body)
  int kw;    // warps a slab (more than one: they share the contraction's keys)
};

// version: the forward's schedule, as the TPU kernels' (3: a group of up to
// 8 heads a block; 2: one head; 1: one head and one sample, whose D columns
// alone a block's column tile covers, B * ceil(D / (64 * ns)) tiles); the
// backward's kinds take 3
Plan plan(Kind kind, int H, int B, int Lo, int Li, int D, int version = 3) {
  Plan p;
  const bool du = kind == DU;
  const int N = B * D;
  const int cols = version == 1 ? D : N;  // the columns a column tile is cut from
  const int slabs = (cols + TN - 1) / TN;
  p.hb = version == 3 ? head_group(H) : 1;
  // the forward and dscale: a warp per head and slab, at most four a block
  // below three heads (a head's slabs share its weights); du: a warp per
  // slab, up to four (each weight computed once for all of them)
  if (du) p.ns = slabs > 8 ? 2 : (slabs >= 3 ? 4 : (slabs >= 2 ? 2 : 1));
  else if (p.hb == 1) p.ns = slabs >= 3 ? 4 : (slabs >= 2 ? 2 : 1);
  else p.ns = p.hb == 2 && slabs >= 2 ? 2 : 1;
  p.tiles = ((du ? Li : Lo) + TM - 1) / TM;
  p.groups = du ? 1 : (H + p.hb - 1) / p.hb;
  // versions 1 and 2 at one slab or less: one-warp blocks whose lanes walk
  // a row each, over the narrowest tile that holds the columns, where the
  // tile is narrow (the 64-column lane tiles of the rounds would be mostly
  // idle) or the blocks fill the card without a split of L_in
  const int n_ct1 = version == 1 ? B : 1;  // the column tiles of one-slab blocks
  p.walk = kind != FWD || version == 3 || slabs > 1 ? 0
           : (cols > WALK_COLS && (long long)p.groups * n_ct1 * p.tiles < WALK_WARPS) ? 0
           : cols <= 4 ? 4 : (cols <= 16 ? 16 : (cols <= 32 ? 32 : 64));
  // their other one-slab blocks: four warps that share the slab's keys
  p.kw = kind == FWD && version != 3 && !p.walk && p.ns == 1 ? KEY_WARPS : 1;
  const int nw = du ? p.ns : p.hb * p.ns * p.kw;
  p.n_ct = (cols + p.ns * TN - 1) / (p.ns * TN) * (version == 1 ? B : 1);
  // split the streamed index until the grid holds about TARGET_WARPS: its
  // groups of GROUP indices dealt to the splits in turn. The forward rounds
  // down (a grid at or below the target), so that a shape just short of 8
  // splits takes the cluster sum and not the scratch sum.
  const int len = du ? Lo : Li;
  const long long base = (long long)p.groups * p.n_ct * p.tiles;
  long long want = kind == FWD ? (p.walk ? WALK_WARPS : TARGET_WARPS) / nw / base
                               : (TARGET_WARPS / nw + base - 1) / base;
  const int groups = (len + GROUP - 1) / GROUP;
  if (want > (du ? MAX_CLUSTER : MAX_SPLITS)) want = du ? MAX_CLUSTER : MAX_SPLITS;
  if (want > groups) want = groups;
  if (want < 1) want = 1;
  const int per = (groups + (int)want - 1) / (int)want;  // groups a split
  p.splits = (groups + per - 1) / per;
  p.R = per * GROUP;
  return p;
}

bool bad_shape(int H, int B, int Lo, int Li, int D) {
  return H < 1 || B < 1 || Lo < 1 || Li < 1 || D < 1 || (Lo + TM - 1) / TM > 65535 ||
         (Li + TM - 1) / TM > 65535 || (long long)B * D > (1LL << 30);
}

bool aligned(const float* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace
