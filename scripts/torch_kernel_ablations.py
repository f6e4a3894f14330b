"""Ablations of the port's per-sample-mesh kernels #8 (dscale, du) and #11
on an NVIDIA GPU: what holds each one's time.

Each variant is the kernel source with one piece of its work taken out or
one design choice changed (a text substitution), built with the port's
nvcc flags into a scratch library and timed with ``chip_smoke.cuda_ms``
(CUDA events) at the full-width elasticity / elasticity_tf processor and
decoder shapes of ``chip_smoke.py``, in turns (base, variants, variants in
reverse, base). Variants that take work out give wrong results; they are
timed only. Prints one JSON object per (op, kernel, variant) and, last,
the card's name and power limit.

    python scripts/torch_kernel_ablations.py

Run from the repository root on a machine with the card and nvcc.
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
    ("#pragma unroll\n      for (int k = 0; k < TK; ++k) {\n        float wv[8], vv[8];",
     "float vv[8];\n#pragma unroll\n      for (int k = 0; k < TK; ++k) {\n        float wv[8];"),
    ("lds4(&sm.v[buf][warp][k][cg * 4], vv);\n        lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4);",
     "if ((k & 1) == 0) { lds4(&sm.v[buf][warp][k][cg * 4], vv); lds4(&sm.v[buf][warp][k][32 + cg * 4], vv + 4); }"),
]
DU_FOUR = "if (a.D > 2 * TN) return launch_shape<true, GROUPED, HB, 4>(a, B, s);"
DS_TWO = "    if (slabs >= 2) return launch_shape<false, false, HB, 2>(a, B, s);"

# source -> variant -> substitutions (old text, new text)
VARIANTS = {
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
        "no_exp": [("const float e = expf(-fmaxf(x, 0.f) * s);", "const float e = -x * s;")],
        "no_staging": [("cp_async16(&sm.v[vb][warp][k][c4], ok ? p : vsrc, ok);", "(void)p;")],
        "half_v_loads": HALF_V_TF,
        "regs_255": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 2;")],
        "steps_of_8": [("constexpr int TK = 16;      // listed columns a step",
                        "constexpr int TK = 8;      // listed columns a step")],
    },
}


def build(scratch: Path) -> dict:
    """Every variant's library, built concurrently: (source, variant) -> path."""
    from position_induced_transformer_torch.kernels import _build

    jobs = {}
    for src, variants in VARIANTS.items():
        text = (CSRC / f"{src}.cu").read_text()
        for name, subs in variants.items():
            body = text
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ablations: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as c
    from position_induced_transformer_torch.kernels import _build
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    c.environment()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        rng = np.random.default_rng(4)
        shapes, _ = c.elasticity_shapes(rng)
        tf_shapes, _ = c.elasticity_tf_shapes(rng)
        for op in ("processor", "decoder"):
            mq, mk, scale, u, thr, starts, kc, width = shapes[op][0]
            out, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, keep_count=kc,
                                                width=width, stats=True)
            g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).cuda()
            calls, kind, _ = tf_shapes[op]
            timed = {
                "posatt_batched_bwd": {
                    "dscale": lambda: kb.posatt_batched_bwd_dscale_cuda(
                        mq, mk, scale, u, out, g, stats, starts, width=width),
                    "du": lambda: kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts,
                                                                width=width),
                },
                "posatt_tf_fwd": {"coord_fwd": lambda: c.tf_launch(calls, kind)},
            }
            for src, variants in VARIANTS.items():
                order = list(variants) + list(reversed(list(variants)))
                ms: dict = {}
                for name in order:
                    _build._loaded[src] = ctypes.CDLL(str(libs[(src, name)]))
                    kb._entry.cache_clear()
                    for kernel, fn in timed[src].items():
                        ms.setdefault((kernel, name), []).append(c.cuda_ms(fn))
                for (kernel, name), t in ms.items():
                    print(json.dumps({"op": op, "kernel": kernel, "variant": name, "ms": t}), flush=True)
        _build._loaded.clear()
        kb._entry.cache_clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
