"""Ablations of the port's kernels on an NVIDIA GPU: what holds each one's
time. #7 (posatt_batched_fwd), #8 (dscale, du), #9 (posatt_tf_fwd), #11
(posatt_tf_coord_fwd, which shares #9's source), the fixed-mesh backward
#3 (dscale) and #4 (du) (posatt_fixed_bwd), the fixed-mesh forward #1
with and without its row statistics and #2, the same kernel without the
contraction (posatt_fixed_fwd), and the schedule variants #5 (v1) and #6
(v2), #1's body under one head a block (posatt_fixed_fwd_v12, the same
source).

Each variant is the kernel source with one piece of its work taken out or
one design choice changed (a text substitution), or, for #9's producer
warp, the source scripts/ablations/posatt_tf_fwd_producer.cu in its place
(in two forms); each is built with the port's nvcc flags into a scratch
library and timed with ``chip_smoke.cuda_ms`` (CUDA events) at the
full-width elasticity / elasticity_tf shapes of ``chip_smoke.py`` (the
fixed-mesh backward at the Burgers training shapes and, through the kernel
API, at the vorticity and sod shapes of ``chip_smoke.config_shapes``; the
fixed-mesh forward at the Burgers shapes and the eight shapes of
``chip_smoke.schedule_shapes``, up to the Darcy 421^2 ZSSR encoder and
decoder), in
turns (base, variants, variants in reverse, base). Variants that take work
out give wrong results; they are timed only. The producer warp's forms are
held against the plain version at the one shape they take (the served
processor). Prints one JSON object per (op, kernel, variant) and, last,
the card's name and power limit.

    python scripts/torch_kernel_ablations.py [--parent CSRC] [--variants V,...] [target ...]

with targets among posatt_batched_fwd, posatt_batched_bwd, posatt_tf_fwd,
posatt_fixed_bwd, posatt_fixed_fwd, posatt_fixed_fwd_v12 (default: all
six; each names its source, but posatt_fixed_fwd_v12, whose source is
posatt_fixed_fwd.cu). ``--variants base,parent`` times only the variants
named (base is always timed first and last). ``--parent CSRC``:
one more variant of each source, the file of the same name in the
directory CSRC (for example the kernels of a parent commit unpacked with
``git archive``), timed in turns with the rest; the fixed-mesh backward's
parent dscale is called through its own C interface (before it read the
forward's output and took counters), and so are the parent's #1 (no row
statistics out), #2 (the same C interfaces; their scratch from the
parent's plan entry, before it took the version) and its v1 and v2
(before they took M, L, scratch and counters). A source that
includes posatt_fixed_common.cuh is built with the header inlined, so a
variant may change it. ``--old-parent CSRC``: the fixed-mesh forward #1
of an older tree whose #1 writes no row statistics (``posatt_fixed_fwd.cu``
in CSRC, its C interface taking dist, thr, scale, u, out and the shape),
timed as one more variant of posatt_fixed_fwd at the ``fwd`` calls. Run from the repository root on a machine with the card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "position_induced_transformer_torch" / "kernels" / "csrc"
PRODUCER = Path(__file__).resolve().parent / "ablations" / "posatt_tf_fwd_producer.cu"

FMA = "acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);"
FEW_FMA = "if (r == c) acc[r][c] = fmaf(wv[r], vv[c], acc[r][c]);"  # 8 of 64 products
# the value rows loaded from shared memory at every other step of the
# contraction only (the same products, a quarter fewer 16-byte loads)
HALF_V_BWD = [
    ("#pragma unroll\n      for (int kk = 0; kk < S::SR; ++kk) {",
     "float vv[8];\n#pragma unroll\n      for (int kk = 0; kk < S::SR; ++kk) {"),
    ("float wv[8], vv[8];\n        lds4(wr + og * 4, wv);", "float wv[8];\n        lds4(wr + og * 4, wv);"),
    ("lds4(vr + cg * 4, vv);\n        lds4(vr + 32 + cg * 4, vv + 4);",
     "if ((kk & 1) == 0) { lds4(vr + cg * 4, vv); lds4(vr + 32 + cg * 4, vv + 4); }"),
]
HALF_V_TF = [
    ("#pragma unroll\n    for (int k = 0; k < TK; ++k) {\n      float wv[8], vv[8];",
     "float vv[8];\n#pragma unroll\n    for (int k = 0; k < TK; ++k) {\n      float wv[8];"),
    ("lds4(&sm.v[buf][warp][k][cg * 4], vv);\n      lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4);",
     "if ((k & 1) == 0) { lds4(&sm.v[buf][warp][k][cg * 4], vv); lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4); }"),
]
DU_FOUR = "if (a.D > 2 * TN) return launch_shape<true, GROUPED, HB, 4>(a, B, s);"
DS_TWO = "    if (slabs >= 2) return launch_shape<false, false, HB, 2>(a, B, s);"
FWD_TWO = "    if (slabs >= 2) return launch_shape<HB, 2>(a, B, s);"
# the output written 4 bytes a store instead of 16
SCALAR_STORES = [("    if (a.vec4) {  // 16-byte stores: a warp writes four whole 128-byte rows",
                  "    if (false) {")]
# pass 2 left out: the row minima, the list and the epilogue only
NO_PASS2 = "(n);\n  // the columns whose rounds"

# the fixed-mesh backward: the next step's rows staged after the step's
# products, not in flight during them
FIXED_NO_PREFETCH = [("      if (s + 1 < steps) stage((s + 1) * SKR, n, buf ^ 1);\n",
                      "      if (s > 0) {\n        stage(s * SKR, n, buf);\n        cp_async_wait_all();\n"
                      "        __syncthreads();\n      }\n")]
# dscale's partials summed by a second kernel, as before the last-block sum
FIXED_TWO_LAUNCH = [
    ("  if (tid == 0)\n    sm.last = atomicAdd(a.counters, 1) == (int)(gridDim.x * gridDim.y * gridDim.z) - 1;",
     "  if (tid == 0) sm.last = 0;"),
    ("// --------------------------------------------------------------- launch\n",
     "__global__ void sum_partials(const float* partial, float* ds, int H, int parts) {\n"
     "  float s = 0.f;\n"
     "  for (int p = threadIdx.x; p < parts; p += 32) s += partial[(size_t)p * H + blockIdx.x];\n"
     "  s = warp_sum(s);\n  if (threadIdx.x == 0) ds[blockIdx.x] = s;\n}\n\n"
     "// --------------------------------------------------------------- launch\n"),
    ("    bwd_kernel<DU, HB, NS><<<grid, S::THREADS, smem, s>>>(a);\n  }\n  return (int)cudaGetLastError();",
     "    bwd_kernel<DU, HB, NS><<<grid, S::THREADS, smem, s>>>(a);\n  }\n  rc = (int)cudaGetLastError();\n"
     "  if (rc != 0 || DU) return rc;\n"
     "  sum_partials<<<a.H, 32, 0, s>>>(a.partial, a.res, a.H, p.n_ct * p.tiles * p.splits);\n"
     "  return (int)cudaGetLastError();"),
]
FIXED_TARGET = "constexpr int TARGET_WARPS = 1056;"
COMMON = "posatt_fixed_common.cuh"
INCLUDE_COMMON = f'#include "{COMMON}"'
FIXED_DU_SLABS = "  if (du) p.ns = slabs > 8 ? 2 : (slabs >= 3 ? 4 : (slabs >= 2 ? 2 : 1));"

FIXED_RC1 = "constexpr int RC1 = 64;"
FIXED_HB = "  p.hb = version == 3 ? head_group(H) : 1;"
FIXED_SPLIT_FLOOR = "  if (want < 1) want = 1;\n"
# version 3's forward at a grid of one partial wave: split L_in in two where
# the blocks a SM gets (the busiest SM's share of the work, in halves of an
# unsplit block) fall by a tenth or more, against the card's own SM count
SM_BALANCE = FIXED_SPLIT_FLOOR + """\
  if (kind == FWD && version == 3 && want == 1 && groups >= 2) {
    static const long long sms = [] {
      int dev = 0, n = 0;
      return cudaGetDevice(&dev) == cudaSuccess &&
             cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && n > 0
             ? (long long)n : 132LL;
    }();
    if (10 * ((2 * base + sms - 1) / sms) <= 9 * 2 * ((base + sms - 1) / sms)) want = 2;
  }
"""
WALK_WARPS = "constexpr int WALK_WARPS = 2 * TARGET_WARPS;"
WALK_COLS = "constexpr int WALK_COLS = 32;"
WALK_RULE = "  p.walk = kind != FWD || version == 3 || slabs > 1 ? 0"
WALK_FILL = "(cols > WALK_COLS && (long long)p.groups * n_ct1 * p.tiles < WALK_WARPS)"
KEY_WARPS = "constexpr int KEY_WARPS = 4;"
WALK_MIN_BLOCKS = "constexpr int WALK_MIN_BLOCKS = 16;"

# target -> variant -> substitutions (old text, new text) in the kernel's
# source, or (path, substitutions) in another source built in its place
VARIANTS = {
    "posatt_batched_fwd": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        "no_exp": [("const float e = expf(-x * sh[h]);", "const float e = -x * sh[h];")],
        "no_staging": [("cp_async16(&sm.v[buf][r][c4], ok ? src + col0 + c4 : a.u, ok);",
                        "(void)src;")],
        "no_pass2": [("  contract" + NO_PASS2, "  // the columns whose rounds")],
        "scalar_stores": SCALAR_STORES,
        # the value slab a block owns at two heads: 256 columns (one block of
        # eight warps a row tile) or 64 (four blocks) against 128 (two)
        "slabs_four": [(FWD_TWO, "    {\n    if (slabs >= 3) return launch_shape<HB, 4>(a, B, s);\n"
                        + FWD_TWO + "\n    }")],
        "slabs_one": [(FWD_TWO, "")],
        "steps_of_32": [("constexpr int TK = 16;        // listed columns a step (at most)",
                         "constexpr int TK = 32;        // listed columns a step (at most)"),
                        ("static constexpr int SK = TK < 4 * NW ? TK : 4 * NW;",
                         "static constexpr int SK = TK < 8 * NW ? TK : 8 * NW;")],
        "regs_128": [("constexpr int SM_WARPS = 12;", "constexpr int SM_WARPS = 16;")],
        "regs_255": [("constexpr int SM_WARPS = 12;", "constexpr int SM_WARPS = 8;")],
    },
    "posatt_batched_bwd": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        "no_exp": [("const float e = expf(-x * sh[h]);", "const float e = -x * sh[h];")],
        "no_weights": [("const float pw = kept ? e * (DU ? p.rden[DU ? q : 0][h] : orden[h]) : 0.f;",
                        "const float pw = 0.f * x;")],
        "no_staging": [("cp_async16(&sm.v[buf][r][c4], ok ? src + col0 + c4 : a.g, ok);", "(void)src;")],
        "half_v_loads": HALF_V_BWD,
        "du_two_slabs": [(DU_FOUR, "")],
        "dscale_one_slab": [(DS_TWO, "")],
        "dscale_four_slabs": [(DS_TWO, DS_TWO.replace("slabs >= 2", "slabs >= 3").replace("HB, 2>", "HB, 4>")
                               + "\n  if constexpr (HB <= 2)\n" + DS_TWO)],
        "regs_128": [("constexpr int SM_WARPS = 12;", "constexpr int SM_WARPS = 16;")],
        "regs_255": [("constexpr int SM_WARPS = 12;", "constexpr int SM_WARPS = 8;")],
    },
    "posatt_tf_fwd": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        "no_exp": [("const float e = expf(-fmaxf(x, 0.f) * s);", "const float e = -x * s;"),
                   ("const float e = expf(-fmaxf(__fsub_rn(d[q], dmin_l), 0.f) * s);",
                    "const float e = -__fsub_rn(d[q], dmin_l) * s;")],
        "no_staging": [("cp_async16(&sm.v[vb][warp][k][c4], ok ? p : vsrc, ok);", "(void)p;")],
        # #9: pass 2 stages the distances of its first two steps only
        "no_dist_loads": [("      stage_d(s0 + 2 * TK, nl, buf);\n", "")],
        "no_pass2": [("  run" + NO_PASS2, "  // the columns whose rounds")],
        "scalar_stores": SCALAR_STORES,
        "half_v_loads": HALF_V_TF,
        "regs_255": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 2;")],
        "steps_of_8": [("constexpr int TK = 16;      // listed columns a step",
                        "constexpr int TK = 8;      // listed columns a step")],
        # pass 2 through a producer warp, TMA copies and mbarriers: two 2-D
        # boxes a step over tensor maps, or a 1-D bulk copy a row
        "producer_warp": (PRODUCER, []),
        "producer_warp_rows": (PRODUCER, [("constexpr bool TENSOR_MAPS = true;",
                                           "constexpr bool TENSOR_MAPS = false;")]),
    },
    "posatt_fixed_bwd": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        "no_exp": [("const float p = expf(-d * sh[h] - sm.mrow[h][slot]) * sm.lrow[h][slot];",
                    "const float p = -d * sh[h] - sm.mrow[h][slot];"),
                   ("const float p = expf(-d * sh[h] - om[h]) * ol[h];",
                    "const float p = -d * sh[h] - om[h];")],
        "no_prefetch": FIXED_NO_PREFETCH,
        # the split count: the grid aims at 4 or 2 warps an SM (fewer
        # splits) or 16 (more) in place of 8
        "target_4_warps": [(FIXED_TARGET, FIXED_TARGET.replace("1056", "528"))],
        "target_2_warps": [(FIXED_TARGET, FIXED_TARGET.replace("1056", "264"))],
        "target_16_warps": [(FIXED_TARGET, FIXED_TARGET.replace("1056", "2112"))],
        # the streamed index cut into contiguous ranges, one a split, in
        # place of groups of 16 dealt to the splits in turn
        "contiguous_splits": [("    return ((t / GROUP) * (int)gridDim.z + (int)blockIdx.z) * GROUP + t % GROUP;",
                               "    return (int)blockIdx.z * a.R + t;")],
        # 32 staged rows a step (half the barriers), not 16
        "steps_of_32": [("constexpr int SK = 16;", "constexpr int SK = 32;")],
        # du's tile: two 64-column slabs (128 columns) or one, or four up to
        # any width, in place of four up to 512 columns and two above
        "du_two_slabs": [(FIXED_DU_SLABS, "  if (du) p.ns = slabs >= 2 ? 2 : 1;")],
        "du_one_slab": [(FIXED_DU_SLABS, "  if (du) p.ns = 1;")],
        "du_four_slabs": [(FIXED_DU_SLABS, "  if (du) p.ns = slabs >= 3 ? 4 : (slabs >= 2 ? 2 : 1);")],
        "dscale_two_launches": FIXED_TWO_LAUNCH,
    },
    "posatt_fixed_fwd": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        "no_exp": [("expf(__fsub_rn(__fmul_rn(-sh[h], d), mh[h]))",
                    "__fsub_rn(__fmul_rn(-sh[h], d), mh[h])")],
        # 32 staged u rows a contraction step (half the barriers), not 16
        "steps_of_32": [("constexpr int SK = 16;", "constexpr int SK = 32;")],
        # rounds of 64 keys at one or two heads, not 128 (more blocks fit on
        # a SM, twice the rounds)
        "rounds_of_64": [("(HB <= 2 ? 128 :", "(HB <= 2 ? 64 :")],
        # the split count: the grid aims at 4 or 16 warps an SM, not 8
        "target_4_warps": [(FIXED_TARGET, FIXED_TARGET.replace("1056", "528"))],
        "target_16_warps": [(FIXED_TARGET, FIXED_TARGET.replace("1056", "2112"))],
        # one 64-column slab a block at two heads (twice the blocks), not two
        "one_slab": [("  else p.ns = p.hb == 2 && slabs >= 2 ? 2 : 1;", "  else p.ns = 1;")],
        # a head a block (and four slabs) where the values are 1024 columns
        # or wider: half the exps a block, the distances scanned once a head
        "one_head_wide": [(FIXED_HB, FIXED_HB + "\n  if (kind == FWD && slabs >= 16) p.hb = 1;")],
        # two splits of L_in where one wave of blocks leaves the SMs uneven
        # (the vorticity processor: 320 blocks of 4 warps on 132 SMs)
        "sm_balance": [(FIXED_SPLIT_FLOOR, SM_BALANCE)],
    },
    "posatt_fixed_fwd_v12": {
        "base": [],
        "few_fma": [(FMA, FEW_FMA)],
        # no row walk: every one-slab block of versions 1 and 2 runs the
        # rounds with key-split warps; or the row walk at every one-slab tile
        "no_walk": [(WALK_RULE, "  p.walk = true ? 0")],
        "walk_cols_64": [(WALK_COLS, WALK_COLS.replace("32", "64"))],
        # the other one-slab blocks: two key-split warps, not four; or one
        # warp, at rounds of 64 keys (about 27 KB of shared memory, 8 blocks
        # a SM) or 128 (44 KB, 5 blocks)
        "key_warps_2": [(KEY_WARPS, KEY_WARPS.replace("4", "2"))],
        "key_warps_1": [(KEY_WARPS, KEY_WARPS.replace("4", "1"))],
        "key_warps_1_rc1_128": [(KEY_WARPS, KEY_WARPS.replace("4", "1")),
                                (FIXED_RC1, FIXED_RC1.replace("64", "128"))],
        # the row walk's split aiming at 1x or 4x the list body's warps, not 2x
        "walk_warps_1x": [(WALK_WARPS, WALK_WARPS.replace("2 *", "1 *"))],
        "walk_warps_4x": [(WALK_WARPS, WALK_WARPS.replace("2 *", "4 *"))],
        # the row walk's one-split output written a lane a row (16 bytes of
        # each line a store), not through shared memory
        "walk_lane_stores": [("      if constexpr (WK > 0) {\n        // a row walk: the normalised rows",
                              "      if constexpr (false) {\n        // a row walk: the normalised rows")],
        # the row walk without its staged u rows (timed only)
        "walk_no_staging": [("          cp_async16(su + k * WP + c, c < live ? ur + sm.coff[c] : a.u, c < live);",
                             "          (void)ur;")],
        # v2 at #1's plan: its blocks own version 3's head groups (so its
        # launches are #1's), against one head a block
        "v2_at_v3_plan": [(FIXED_HB, "  p.hb = version == 1 ? 1 : head_group(H);")],
    },
}
# the source file of a target, where it is not the target's name
SOURCE = {"posatt_fixed_fwd_v12": "posatt_fixed_fwd"}
# variants that take only some (op, kernel)s
ONLY = {("posatt_tf_fwd", v): {("serve_processor", "dist_fwd")}
        for v in ("producer_warp", "producer_warp_rows")}


def inlined(path: Path) -> str:
    """A kernel source with the shared fixed-mesh header, where it includes
    it, put in place of the include."""
    text = path.read_text()
    if INCLUDE_COMMON in text:
        text = text.replace(INCLUDE_COMMON, (path.parent / COMMON).read_text())
    return text


def build(scratch: Path, sources) -> dict:
    """Every variant's library, built concurrently: (target, variant) -> path."""
    from position_induced_transformer_torch.kernels import _build

    jobs = {}
    for src in sources:
        text = inlined(CSRC / f"{SOURCE.get(src, src)}.cu")
        for name, subs in VARIANTS[src].items():
            body = text
            if isinstance(subs, tuple):
                path, subs = subs
                body = inlined(path)
            for old, new in subs:
                if body.count(old) != 1:
                    raise RuntimeError(f"{src} {name}: {old!r} is not in the source exactly once")
                body = body.replace(old, new)
            cu = scratch / f"{src}-{name}.cu"
            cu.write_text(body)
            out = cu.with_suffix(".so")
            proc = subprocess.Popen(_build.nvcc_command(cu, out), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[(src, name)] = (out, proc)
    libs = {}
    for key, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = out
    return libs


def fixed_bwd_calls(c, rng) -> dict:
    """The fixed-mesh backward's timed calls: dscale at the Burgers encoder,
    processor and decoder, du at the processor and decoder (a Burgers
    step's launches), both at the shapes of ``chip_smoke.config_shapes``;
    (op, kernel) -> {"new": launch, "parent": the parent's launch} (dscale's
    through the parent's own C interface). Inputs (row statistics, the forward's output) are
    made with the base library."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import posatt

    geom = c.burgers_geometry("cuda")
    m = configs.BURGERS.model
    inf = lambda Lo: torch.full((Lo, 1), float("inf"), device="cuda")
    ops = [("burgers_encoder", geom.dist_down, geom.thr_down, c.BURGERS_B, m.n_head,
            m.in_dim + m.space_dim),
           ("burgers_processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), c.BURGERS_B,
            m.n_head, m.hid_dim),
           ("burgers_decoder", geom.dist_up, geom.thr_up, c.BURGERS_B, m.n_head, m.hid_dim)]
    ops += c.config_shapes()
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    calls = {}
    for op, dist, thr, B, H, D in ops:
        Lo, Li = dist.shape
        scale = posatt.bandwidth_scale(to(rng.random((H, 1, 1)))).reshape(H, 1)
        u = to(rng.standard_normal((B, Li, D)))
        g = to(rng.standard_normal((B, Lo, H * D)))
        out, M, L = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
        # the parent's scratch: a partial per block of its narrowest tiles
        partial = torch.empty((-(-Lo // 8) * -(-(B * D) // 32), H), device="cuda")
        ds = torch.empty((H, 1), device="cuda")
        dims = (H, B, Lo, Li, D)

        def parent_dscale(a=(dist, thr, scale, M, L, g, u, partial, ds) + dims):
            fn = kp._entry("posatt_fixed_bwd", "posatt_bwd_dscale", 9, 5)
            kp._launch(fn, "parent dscale", a[0].device, *a)

        calls[(op, "dscale")] = {
            "new": lambda a=(dist, thr, scale, M, L, g, u, out): kp.posatt_bwd_dscale_cuda(*a),
            "parent": parent_dscale}
        if op != "burgers_encoder":  # a Burgers step needs no dU there
            du = lambda a=(dist, thr, scale, M, L, g): kp.posatt_bwd_du_cuda(*a)
            calls[(op, "du")] = {"new": du, "parent": du}  # one C interface
    torch.cuda.synchronize()
    return calls


def fixed_fwd_calls(c, rng) -> dict:
    """The fixed-mesh forward's timed calls at the Burgers shapes (the
    model's geometry) and the shapes of phase 16 (``schedule_shapes``):
    (op, kernel) -> {"new": launch, "parent": the parent's launch}; kernel
    ``fwd`` (#1 alone, as serving runs it), ``fwd_stats`` (#1 with M and L
    out, as training runs it) and ``stats`` (#2 alone). The parent's #1 and
    #2 take the same C interfaces; their scratch comes from the parent's
    own plan entry (no version, no warps out)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import _build
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import posatt

    geom = c.burgers_geometry("cuda")
    m = configs.BURGERS.model
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    inf = lambda Lo: torch.full((Lo, 1), float("inf"), device="cuda")
    ops = [("burgers_encoder", geom.dist_down, geom.thr_down, c.BURGERS_B, m.in_dim + m.space_dim),
           ("burgers_processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), c.BURGERS_B,
            m.hid_dim),
           ("burgers_decoder", geom.dist_up, geom.thr_up, c.BURGERS_B, m.hid_dim)]
    ops = [(op, dist, thr, to(rng.random((m.n_head, 1, 1))), to(rng.standard_normal(
        (B, dist.shape[1], D)))) for op, dist, thr, B, D in ops]
    shapes = c.schedule_shapes()
    ops += [(f"phase16_{name}", dist, thr, lmda, u)
            for name, (dist, thr, lmda, u, _, _) in c.schedule_cases(shapes).items()]
    calls = {}
    for op, dist, thr, lmda, u in ops:
        H = lmda.shape[0]
        B, Li, D = u.shape
        Lo = dist.shape[0]
        scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
        out = torch.empty((B, Lo, H * D), device="cuda")
        M, L = torch.empty((H, Lo), device="cuda"), torch.empty((H, Lo), device="cuda")

        def parent_scratch(out_, dims=(H, B, Lo, Li, D), device=dist.device):
            fn = getattr(_build.load("posatt_fixed_fwd"), "posatt_fwd_plan")
            fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
                ctypes.POINTER(ctypes.c_int)]
            floats, tiles, splits = ctypes.c_longlong(0), ctypes.c_longlong(0), ctypes.c_int(0)
            fn(int(out_), *dims, ctypes.byref(floats), ctypes.byref(tiles), ctypes.byref(splits))
            if not floats.value:
                return None, None
            return (torch.empty(floats.value, device="cuda"),
                    kp._counters(device, tiles.value))

        # (every name of this op bound as a default: the loop rebinds them)
        def parent_fwd(stats, a=(dist, thr, scale, u, out), ml=(M, L), dims=(H, B, Lo, Li, D),
                       scratch=parent_scratch):
            scr, cnt = scratch(True)
            kp._launch(kp._entry("posatt_fixed_fwd", "posatt_fixed_fwd", 9, 5), "parent #1",
                       a[0].device, *a, *(ml if stats else (None, None)), scr, cnt, *dims)

        def parent_stats(a=(dist, thr, scale, M, L), dims=(H, B, Lo, Li, D),
                         scratch=parent_scratch):
            scr, cnt = scratch(False)
            kp._launch(kp._entry("posatt_fixed_fwd", "posatt_stats", 7, 5), "parent #2",
                       a[0].device, *a, scr, cnt, *dims)

        def old_parent_fwd(a=(dist, thr, scale, u, out), dims=(H, B, Lo, Li, D)):
            kp._launch(kp._entry("posatt_fixed_fwd", "posatt_fixed_fwd", 5, 5), "old parent #1",
                       a[0].device, *a, *dims)

        calls[(op, "fwd")] = {"new": lambda a=(dist, thr, scale, u): kp.posatt_fixed_cuda(*a),
                              "parent": lambda f=parent_fwd: f(False), "old_parent": old_parent_fwd}
        calls[(op, "fwd_stats")] = {
            "new": lambda a=(dist, thr, scale, u): kp.posatt_fixed_cuda(*a, stats=True),
            "parent": lambda f=parent_fwd: f(True)}
        calls[(op, "stats")] = {
            "new": lambda a=(dist, thr, scale), k=dict(B=B, D=D): kp.posatt_stats_cuda(*a, **k),
            "parent": parent_stats}
    torch.cuda.synchronize()
    return calls


def fixed_v12_calls(c, rng) -> dict:
    """The schedule variants' timed calls at the Burgers shapes (the
    model's geometry) and the shapes of phase 16: (op, "v1" or "v2") ->
    {"new": launch, "parent": the parent's launch through its own C
    interface (no M, L, scratch or counters)}; each without M and L out, as
    phase 16's "ms"."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import posatt

    geom = c.burgers_geometry("cuda")
    m = configs.BURGERS.model
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    inf = lambda Lo: torch.full((Lo, 1), float("inf"), device="cuda")
    ops = [("burgers_encoder", geom.dist_down, geom.thr_down, c.BURGERS_B, m.in_dim + m.space_dim),
           ("burgers_processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), c.BURGERS_B,
            m.hid_dim),
           ("burgers_decoder", geom.dist_up, geom.thr_up, c.BURGERS_B, m.hid_dim)]
    ops = [(op, dist, thr, to(rng.random((m.n_head, 1, 1))), to(rng.standard_normal(
        (B, dist.shape[1], D)))) for op, dist, thr, B, D in ops]
    ops += [(f"phase16_{name}", dist, thr, lmda, u)
            for name, (dist, thr, lmda, u, _, _) in c.schedule_cases(c.schedule_shapes()).items()]
    calls = {}
    for op, dist, thr, lmda, u in ops:
        H = lmda.shape[0]
        B, Li, D = u.shape
        Lo = dist.shape[0]
        scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
        out = torch.empty((B, Lo, H * D), device="cuda")
        for v, launch in ((1, kp.posatt_fixed_v1_cuda), (2, kp.posatt_fixed_v2_cuda)):
            def parent(a=(dist, thr, scale, u, out, H, B, Lo, Li, D), name=f"posatt_fixed_fwd_v{v}"):
                kp._launch(kp._entry("posatt_fixed_fwd", name, 5, 5), "parent " + name,
                           dist.device, *a)

            calls[(op, f"v{v}")] = {"new": lambda f=launch, a=(dist, thr, scale, u): f(*a),
                                    "parent": parent}
    torch.cuda.synchronize()
    return calls


def main(sources, parent=None, only=None, old_parent=None) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ablations: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as c
    from position_induced_transformer_torch.kernels import _build
    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.kernels import posatt_pallas as kp

    c.environment()
    rng = np.random.default_rng(4)
    shapes, _ = c.elasticity_shapes(rng)
    tf_shapes, _ = c.elasticity_tf_shapes(rng)
    c.build()
    timed = {src: {} for src in sources}  # source -> (op, kernel) -> launch
    # the fixed-mesh backward: (op, kernel) -> {"new" or "parent": launch}
    fixed = fixed_bwd_calls(c, rng) if "posatt_fixed_bwd" in sources else {}
    # the served decoder also over a cloud in a random order, as a request
    # may hold it
    shapes["serve_decoder_unsorted"] = (c.unsorted_batched(shapes["serve_decoder"][0]),)
    for op in ("processor", "decoder", "serve_decoder", "serve_decoder_unsorted"):
        mq, mk, scale, u, thr, starts, kc, width = shapes[op][0]
        kw = dict(keep_count=kc, width=width)
        timed.setdefault("posatt_batched_fwd", {})[(op, "fwd")] = (
            lambda mq=mq, mk=mk, scale=scale, u=u, thr=thr, starts=starts, kw=kw:
            kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, **kw))
        if op.startswith("serve_decoder"):
            continue
        out, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, stats=True, **kw)
        g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).cuda()
        w = dict(width=width)
        timed.setdefault("posatt_batched_bwd", {}).update({
            (op, "dscale"): lambda mq=mq, mk=mk, scale=scale, u=u, out=out, g=g, stats=stats,
            starts=starts, w=w: kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats,
                                                                   starts, **w),
            (op, "du"): lambda mq=mq, mk=mk, scale=scale, g=g, stats=stats, starts=starts, w=w:
            kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w),
        })
    for op, kernel in (("processor", "coord_fwd"), ("decoder", "coord_fwd"),
                       ("serve_processor", "dist_fwd"), ("serve_encoder", "dist_fwd")):
        calls, kind, _ = tf_shapes[op]
        timed.setdefault("posatt_tf_fwd", {})[(op, kernel)] = (
            lambda calls=calls, kind=kind: c.tf_launch(calls, kind))
    unsorted = c.unsorted_dist(tf_shapes["serve_encoder"][0][1])
    timed["posatt_tf_fwd"][("serve_encoder_unsorted", "dist_fwd")] = (
        lambda: kb.posatt_tf_cuda(*unsorted))
    want = kb.posatt_tf_reference(*tf_shapes["serve_processor"][0][1])

    if parent is not None:
        for src in sources:
            VARIANTS[src]["parent"] = (Path(parent) / f"{SOURCE.get(src, src)}.cu", [])
    if old_parent is not None and "posatt_fixed_fwd" in sources:
        VARIANTS["posatt_fixed_fwd"]["old_parent"] = (Path(old_parent) / "posatt_fixed_fwd.cu", [])
    if only is not None:
        for src in sources:
            VARIANTS[src] = {k: v for k, v in VARIANTS[src].items()
                             if k in ("base", "old_parent") or k in only}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), sources)
        fixed_fwd = fixed_fwd_calls(c, rng) if "posatt_fixed_fwd" in sources else {}
        fixed_v12 = fixed_v12_calls(c, rng) if "posatt_fixed_fwd_v12" in sources else {}
        for src in sources:
            variants = list(VARIANTS[src])
            ms: dict = {}
            checked = set()
            for name in ["base"] + variants[1:] + variants[::-1]:
                _build._loaded[SOURCE.get(src, src)] = ctypes.CDLL(str(libs[(src, name)]))
                kb._entry.cache_clear()
                kp._entry.cache_clear()
                kp._bwd_plan.cache_clear()
                kp._fwd_plan.cache_clear()
                if src in ("posatt_fixed_bwd", "posatt_fixed_fwd", "posatt_fixed_fwd_v12"):
                    calls = {"posatt_fixed_bwd": fixed, "posatt_fixed_fwd": fixed_fwd,
                             "posatt_fixed_fwd_v12": fixed_v12}[src]
                    pick = name if name in ("parent", "old_parent") else "new"
                    timed[src] = {key: fns[pick] for key, fns in calls.items() if pick in fns}
                only = ONLY.get((src, name))
                if only is not None and name not in checked:
                    got = c.tf_launch(*tf_shapes["serve_processor"][:2])
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ok = bool(((got - want).abs() <= c.OP_ATOL + c.OP_RTOL * want.abs()).all())
                    print(json.dumps({"variant": name, "op": "serve_processor", "max_abs_err": err,
                                      "within_rtol_2e-5_atol_2e-6": ok}), flush=True)
                    checked.add(name)
                for key, fn in timed[src].items():
                    if only is None or key in only:
                        ms.setdefault((key, name), []).append(c.cuda_ms(fn))
            for ((op, kernel), name), t in ms.items():
                print(json.dumps({"op": op, "kernel": kernel, "source": src, "variant": name,
                                  "ms": t}), flush=True)
        _build._loaded.clear()
        kb._entry.cache_clear()
        kp._entry.cache_clear()
        kp._bwd_plan.cache_clear()
        kp._fwd_plan.cache_clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a directory of kernel sources to time as one more variant")
    ap.add_argument("--variants", help="comma-separated variants to time beside base (default: all)")
    ap.add_argument("--old-parent", help="a directory holding an older posatt_fixed_fwd.cu whose "
                    "#1 writes no row statistics, to time through its own C interface")
    ap.add_argument("sources", nargs="*", help=f"targets among {', '.join(VARIANTS)} (default: all)")
    args = ap.parse_args()
    if set(args.sources) - set(VARIANTS):
        ap.error(f"unknown sources {sorted(set(args.sources) - set(VARIANTS))}")
    only = set(args.variants.split(",")) if args.variants else None
    sys.exit(main(args.sources or list(VARIANTS), args.parent, only, args.old_parent))
