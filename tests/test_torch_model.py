"""The port's geometry and PiT forward against the JAX package, on the CPU.

Geometry must agree bit for bit with ``build_geometry`` (the Burgers
decoder's cut falls inside a tie of two equal distances, so a rounding
difference in a distance would change the kept sets). The forward runs the
same JAX-initialised weights through both packages; it holds at rtol 1e-4
/ atol 1e-5, looser than the single-op bound (2e-5 / 2e-6) because the
summation-order differences of up to seven attention layers and seven
MLPs compound. Measured on the CPU: at most 4.4e-7 absolute, and 1.5e-5 on
outputs of magnitude 9 in the residual-output case.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.models import PiT as TPiT
from position_induced_transformer_torch.models import build_geometry as t_build
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.utils.torch_compat import (
    flax_params_to_state_dict,
)
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build
from position_induced_transformer_tpu.models import build_geometry_host
from position_induced_transformer_tpu.utils.torch_compat import (
    flax_params_to_torch_state_dict,
)

torch.set_num_threads(1)

MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5


def _np(a):
    return None if a is None else np.asarray(a)


@pytest.mark.parametrize("jax_route", ["build_geometry", "build_geometry_host"])
def test_burgers_geometry_bit_equal(jax_route):
    """Full Burgers grid, 1024 -> 256 -> 1024, periodic, locality 0.02."""
    mesh = j_meshes.grid_1d(1024)
    ltt = j_meshes.grid_1d(256)
    build = j_build if jax_route == "build_geometry" else build_geometry_host
    jg = build(
        jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
        metric="periodic1d", en_loc=0.02, de_loc=0.02,
    )
    tg = t_build(mesh, ltt, mesh, metric="periodic1d", en_loc=0.02,
                 de_loc=0.02, device="cpu")
    for name in ("mesh_in", "dist_down", "dist_proc", "dist_up"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), _np(getattr(jg, name)), name)
    for name in ("thr_down", "thr_up"):
        got, want = getattr(tg, name).numpy(), _np(getattr(jg, name))
        if jax_route == "build_geometry":
            np.testing.assert_array_equal(got, want, name)
        else:
            # the native builder interpolates its quantile in another order:
            # within one f32 ulp, and the kept sets below are still equal
            np.testing.assert_allclose(got, want, rtol=float(np.finfo(np.float32).eps), atol=0)
    keep_down = (tg.dist_down <= tg.thr_down).numpy()
    keep_up = (tg.dist_up <= tg.thr_up).numpy()
    np.testing.assert_array_equal(keep_down, np.asarray(jg.dist_down <= jg.thr_down))
    np.testing.assert_array_equal(keep_up, np.asarray(jg.dist_up <= jg.thr_up))
    assert (keep_down.sum(1) == 21).all()
    per_row = keep_up.sum(1)
    # every 4th output point sits on a latent point; there the cut falls
    # inside a tie and both tied neighbours are kept
    assert (per_row[::4] == 7).all()
    assert set(per_row.tolist()) == {6, 7}


def test_geometry_rejects_batched_meshes():
    m = np.zeros((2, 8, 1), np.float32)
    with pytest.raises(ValueError, match="fixed"):
        t_build(m, m, m, device="cpu")


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = np.zeros((8, 1), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(m, m, m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bench.setup_burgers(t_configs.BURGERS, ntrain=2, ntest=2)


def _small(cfg, **model_kw):
    return dataclasses.replace(
        cfg, grid=(128,), latent_grid=(32,),
        model=dataclasses.replace(cfg.model, hid_dim=16, n_head=2, n_blocks=2, **model_kw),
    )


CASES = {
    "burgers_small": {},
    "burgers_structure": {"hid_dim": 64, "n_blocks": 5},
    "instance_norm_residual": {"use_instance_norm": True, "residual_output": True},
    "no_mesh_concat_8_heads": {"concat_mesh": False, "n_head": 8},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pit_forward_matches_jax(case):
    kw = dict(hid_dim=16, n_head=2, n_blocks=2)
    kw.update(CASES[case])
    m = dataclasses.replace(t_configs.BURGERS.model, **kw)
    L, Lt = 128, 32
    mesh, ltt = j_meshes.grid_1d(L), j_meshes.grid_1d(Lt)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, L, m.in_dim)).astype(np.float32)
    fields = dict(
        space_dim=m.space_dim, in_dim=m.in_dim, out_dim=m.out_dim,
        hid_dim=m.hid_dim, n_head=m.n_head, n_blocks=m.n_blocks,
        en_loc=m.en_loc, de_loc=m.de_loc, concat_mesh=m.concat_mesh,
        use_instance_norm=m.use_instance_norm, residual_output=m.residual_output,
    )
    jg = j_build(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
                 metric="periodic1d", en_loc=m.en_loc, de_loc=m.de_loc)
    jmodel = JPiT(**fields)
    params = jmodel.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jg, jnp.asarray(x)))

    tmodel = TPiT(**fields)
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    tg = t_build(mesh, ltt, mesh, metric="periodic1d", en_loc=m.en_loc,
                 de_loc=m.de_loc, device="cpu")
    with torch.no_grad():
        got = tmodel(tg, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, L, m.out_dim)
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_state_dict_keys_match_reference_names():
    """The port's parameter names are the reference torch state dict's, as
    the JAX package's exporter writes them; shapes agree too."""
    cfg = _small(t_configs.BURGERS)
    m = cfg.model
    mesh, ltt = j_meshes.grid_1d(128), j_meshes.grid_1d(32)
    jg = j_build(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
                 metric="periodic1d")
    jmodel = JPiT(m.space_dim, m.in_dim, m.out_dim, m.hid_dim, m.n_head,
                  m.n_blocks, m.en_loc, m.de_loc)
    params = jmodel.init(jax.random.PRNGKey(1), jg, jnp.ones((1, 128, 1)))["params"]
    ref = flax_params_to_torch_state_dict(params)
    ours = t_bench._make_model(cfg).state_dict()
    assert set(ours) == set(ref)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }
    converted = flax_params_to_state_dict(params)
    for k, v in ref.items():
        np.testing.assert_array_equal(converted[k].numpy(), v)


def test_model_rejects_other_compute_dtypes():
    with pytest.raises(NotImplementedError, match="float32"):
        TPiT(1, 1, 1, 8, 2, 1, 0.1, 0.1, compute_dtype="bfloat16")


def test_setup_names_unported_benchmarks():
    # every built-in benchmark is ported, and every TF-family model variant:
    # darcy_tf's lite model takes dot-product attention in its processor
    assert set(t_bench.SETUPS) >= set(t_configs.BUILTIN)
    lite = dataclasses.replace(t_configs.DARCY_TF, model_variant="lite")
    problem = t_bench.setup(lite, ntrain=8, ntest=2, device="cpu")
    assert type(problem.model.MHPA_0).__name__ == "MultiHeadSelfAtt"
    with pytest.raises(ValueError, match=re.escape("unknown model variant 'nope'")):
        t_bench.setup(dataclasses.replace(lite, model_variant="nope"), ntrain=8, ntest=2,
                      device="cpu")
    with pytest.raises(ValueError, match="unknown benchmark"):
        t_configs.get("nope")
