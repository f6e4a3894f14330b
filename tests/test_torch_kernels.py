"""The fixed-mesh attention kernel's wrapper, on the CPU and on the card.

On the CPU the wrapper runs the kernel's plain version; it is held against
the JAX package's Pallas v3 kernel run in interpret mode, at rtol 2e-5 /
atol 2e-6 (the bound of tests/test_pallas.py: both float32, sums in another
order). The CUDA kernel itself is tested on the card by test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.kernels import posatt_pallas as t_k
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_tpu.kernels import posatt_pallas as j_k
from position_induced_transformer_tpu.ops import distances as j_dist

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 2e-6

SHAPES = [
    (64, 64, 2, 2, 8, 0.3),  # self attention, masked
    (64, 64, 2, 1, 8, 1.0),  # global (processor blocks)
    (16, 200, 3, 2, 4, 0.1),  # cross, L_in not tile-aligned
    (100, 48, 2, 2, 16, 0.5),  # L_out not tile-aligned
    (40, 72, 2, 8, 4, 0.2),  # eight heads
]


def _inputs(L_out, L_in, B, H, D, seed=0):
    rng = np.random.default_rng(seed)
    mo = jnp.asarray(rng.random((L_out, 2)), jnp.float32)
    mi = jnp.asarray(rng.random((L_in, 2)), jnp.float32)
    dist = np.array(j_dist.euclidean_sq(mo, mi))
    lmda = rng.standard_normal((H, 1, 1)).astype(np.float32)
    u = rng.random((B, L_in, D)).astype(np.float32)
    return dist, lmda, u


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_wrapper_cpu_matches_interpret_v3(L_out, L_in, B, H, D, loc):
    dist, lmda, u = _inputs(L_out, L_in, B, H, D)
    before = t_k.posatt_fixed_cuda.launches
    got = t_k.position_attention_fixed(
        torch.from_numpy(dist), torch.from_numpy(lmda), torch.from_numpy(u), loc
    ).numpy()
    want = np.asarray(j_k.position_attention_fixed(
        jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), loc,
        interpret=True, version=3,
    ))
    assert got.shape == (B, L_out, H * D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert t_k.posatt_fixed_cuda.launches == before  # the CPU path launches nothing


def test_reference_matches_model_oracle_with_global_rows():
    """The kernel's plain version equals the model-level oracle, including
    an all-masked-but-one row and +inf distances (the ``d < inf`` term)."""
    dist, lmda, u = _inputs(24, 40, 2, 2, 3, seed=5)
    dist[3, :] = np.inf
    dist[3, 7] = 0.5
    d, lm, x = map(torch.from_numpy, (dist, lmda, u))
    thr = t_loc.quantile_threshold(d, 0.2)
    scale = t_posatt.bandwidth_scale(lm).reshape(2, 1)
    got = t_k.posatt_fixed_reference(d, thr, scale, x)
    got = got.permute(1, 2, 0, 3).reshape(2, 24, 6)
    want = t_posatt.position_attention(d, lm, x, 0.2, thr=thr)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda d, l, u: (d.double(), l, u), TypeError),
        (lambda d, l, u: (d, l, u.double()), TypeError),
        (lambda d, l, u: (d.t(), l, u), ValueError),  # wrong shape and layout
        (lambda d, l, u: (d, l, u[:, :-1]), ValueError),
        (lambda d, l, u: (d[None], l, u), ValueError),
        (lambda d, l, u: (d, l, u.transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda d, l, u: (d.to("meta"), l.to("meta"), u.to("meta")), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    dist, lmda, u = mutate(dist, lmda, u)
    with pytest.raises(err):
        t_k.position_attention_fixed(dist, lmda, u, 0.3)


def test_kernel_launcher_refuses_cpu_tensors():
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    thr = torch.full((16, 1), float("inf"))
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_fixed_cuda(dist, thr, torch.ones(2, 1), u)


def test_module_imports_without_nvcc_or_gpu():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_VISIBLE_DEVICES="")
    code = (
        "import sys, position_induced_transformer_torch.kernels as k;"
        "assert 'triton' not in sys.modules;"
        "assert k.posatt_fixed_cuda.launches == 0;"
        "print('ok')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_build_command_targets_sm90a():
    src = _build.CSRC / "posatt_fixed_fwd.cu"
    assert src.exists()
    cmd = _build.nvcc_command(src, Path("/tmp/x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    # the library name follows the source's content
    assert _build.library_path("posatt_fixed_fwd").name.startswith("libposatt_fixed_fwd-")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_build_dir_is_gitignored():
    rel = _build.BUILD_DIR.relative_to(REPO)
    patterns = {
        line.strip().strip("/")
        for line in (REPO / ".gitignore").read_text().splitlines()
    }
    assert any(str(p) in patterns for p in [rel, *rel.parents] if str(p) != ".")
