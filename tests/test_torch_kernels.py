"""The fixed-mesh attention kernels' wrappers, on the CPU.

On the CPU each wrapper runs its kernel's plain version; each is held
against the JAX package's Pallas kernel run in interpret mode, at rtol 2e-5
/ atol 2e-6 (the bound of tests/test_pallas.py: both float32, sums in
another order). The bandwidth gradient is a cancelling sum and is held at
that file's rtol 5e-4 / atol 5e-6. The CUDA kernels themselves are tested
on the card by test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
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
from position_induced_transformer_tpu.ops import locality as j_loc

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
    scale = torch.ones(2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_fixed_cuda(dist, thr, scale, u)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_stats_cuda(dist, thr, scale)
    M = torch.zeros(2, 16, 1)
    g = torch.zeros(2, 16, 6)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_bwd_du_cuda(dist, thr, scale, M, M, g)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_bwd_dscale_cuda(dist, thr, scale, M, M, g, u)


# the shapes of tests/test_pallas.py's fused-backward test
BWD_SHAPES = [
    (48, 48, 2, 2, 8, 0.4),  # self, masked
    (16, 200, 3, 2, 4, 0.1),  # cross, unaligned L_in
    (100, 48, 2, 1, 16, 1.0),  # global, unaligned L_out
]


def _bwd_inputs(L_out, L_in, B, H, D, loc, seed=1):
    """numpy (dist, thr, scale, u, g, lmda); g is an output cotangent in the
    port's (B, L_out, H*D) layout."""
    dist, lmda, u = _inputs(L_out, L_in, B, H, D, seed)
    if loc >= 1:
        thr = np.full((L_out, 1), np.inf, np.float32)
    else:
        thr = np.asarray(j_loc.quantile_threshold(jnp.asarray(dist), loc))
    scale = np.asarray(t_posatt.bandwidth_scale(torch.from_numpy(lmda))).reshape(H, 1)
    g = np.random.default_rng(seed + 1).standard_normal((B, L_out, H * D)).astype(np.float32)
    return dist, thr, scale, u, g, lmda


def _folded(g, u, H):
    """The JAX kernels' folded layouts: gf (H, L_out, B*D), uf (L_in, B*D)."""
    B, L_out, HD = g.shape
    D = HD // H
    gf = g.reshape(B, L_out, H, D).transpose(2, 1, 0, 3).reshape(H, L_out, B * D)
    uf = u.transpose(1, 0, 2).reshape(u.shape[1], -1)
    return jnp.asarray(gf), jnp.asarray(uf)


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_backward_plain_versions_match_interpret_kernels(L_out, L_in, B, H, D, loc):
    dist, thr, scale, u, g, _ = _bwd_inputs(L_out, L_in, B, H, D, loc)
    t = lambda a: torch.from_numpy(np.array(a))
    M, L = t_k.posatt_stats_reference(t(dist), t(thr), t(scale))
    jM, jL = j_k._posatt_stats(
        jnp.asarray(dist), jnp.asarray(thr), jnp.asarray(scale), interpret=True
    )
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=RTOL, atol=ATOL)

    gf, uf = _folded(g, u, H)
    jargs = (jnp.asarray(dist), jnp.asarray(thr), jnp.asarray(scale), jM, jL, gf)
    du = t_k.posatt_bwd_du_reference(t(dist), t(thr), t(scale), M, L, t(g))
    jdu = np.asarray(j_k._posatt_bwd_du(*jargs, interpret=True))
    jdu = jdu.reshape(L_in, B, D).transpose(1, 0, 2)
    assert du.shape == (B, L_in, D)
    np.testing.assert_allclose(du.numpy(), jdu, rtol=RTOL, atol=ATOL)

    ds = t_k.posatt_bwd_dscale_reference(t(dist), t(thr), t(scale), M, L, t(g), t(u))
    jds = np.asarray(j_k._posatt_bwd_dscale(*jargs, uf, interpret=True))
    assert ds.shape == (H, 1)
    np.testing.assert_allclose(ds.numpy(), jds, rtol=5e-4, atol=5e-6)


def test_backward_plain_versions_keep_global_and_padded_rows_finite():
    """A row of +inf distances but one, global attention (thr = +inf) and a
    zero bandwidth scale: masked entries are exactly 0, with no inf * 0."""
    dist, _, u, = map(torch.from_numpy, _inputs(12, 20, 2, 2, 3, seed=3))
    dist[4, :] = float("inf")
    dist[4, 5] = 0.25
    thr = torch.full((12, 1), float("inf"))
    scale = torch.tensor([[0.0], [2.0]])
    g = torch.ones(2, 12, 6)
    M, L = t_k.posatt_stats_reference(dist, thr, scale)
    du = t_k.posatt_bwd_du_reference(dist, thr, scale, M, L, g)
    ds = t_k.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u)
    assert torch.isfinite(M).all() and torch.isfinite(L).all()
    assert torch.isfinite(du).all() and torch.isfinite(ds).all()
    # row 4 keeps one entry with weight 1 in both heads
    assert float(L[0, 4, 0]) == 1.0 and float(L[1, 4, 0]) == 1.0


def _torch_grads(fn, dist, lmda, u, loc, w):
    lm = torch.from_numpy(lmda).requires_grad_(True)
    x = torch.from_numpy(u).requires_grad_(True)
    out = fn(torch.from_numpy(dist), lm, x, loc)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), lm.grad.numpy(), x.grad.numpy()


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_function_gradients_match_jax_fused_backward(L_out, L_in, B, H, D, loc):
    """The autograd Function (its CPU path: the plain versions of all four
    kernels) against jax.grad of the JAX custom VJP with the fused backward
    in interpret mode, and against torch.autograd of the plain oracle."""
    dist, _, u, w, lmda = (_bwd_inputs(L_out, L_in, B, H, D, loc)[i] for i in (0, 1, 3, 4, 5))
    before = [f.launches for f in (t_k.posatt_fixed_cuda, t_k.posatt_stats_cuda)]
    got = _torch_grads(t_k.position_attention_fixed, dist, lmda, u, loc, w)
    assert [f.launches for f in (t_k.posatt_fixed_cuda, t_k.posatt_stats_cuda)] == before
    oracle = _torch_grads(t_posatt.position_attention, dist, lmda, u, loc, w)

    def loss(lm, x):
        out = j_k.position_attention_fixed(
            jnp.asarray(dist), lm, x, loc, interpret=True, fused_bwd=True
        )
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lmda), jnp.asarray(u))
    for want in ((None, *map(np.asarray, jg)), oracle):
        np.testing.assert_allclose(got[1], want[1], rtol=5e-4, atol=5e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=5e-4, atol=5e-6)
    np.testing.assert_allclose(got[0], oracle[0], rtol=RTOL, atol=ATOL)


def test_no_grad_forward_skips_the_function():
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    lmda.requires_grad_(True)
    with torch.inference_mode():
        out = t_k.position_attention_fixed(dist, lmda, u, 0.3)
    assert out.grad_fn is None
    out = t_k.position_attention_fixed(dist, lmda, u, 0.3)
    assert type(out.grad_fn).__name__ == "PosAttFixedBackward"


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
    assert set(_build.KERNELS) == {"posatt_fixed_fwd", "posatt_fixed_bwd"}
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_build_dir_is_gitignored():
    rel = _build.BUILD_DIR.relative_to(REPO)
    patterns = {
        line.strip().strip("/")
        for line in (REPO / ".gitignore").read_text().splitlines()
    }
    assert any(str(p) in patterns for p in [rel, *rel.parents] if str(p) != ".")
