"""The port's data-parallel and sequence-parallel evaluation and inference
on the CPU under gloo, each rank a process of its own
(tests/torch_ranks.py), against the single-process port at the JAX
package's tolerances (metrics rtol 1e-5, predictions rtol 1e-5 / atol
1e-6): ``evaluate(mesh="data=2")`` with the shuffle ablation, the ZSSR
decode split over the ranks by query rows for Darcy and darcy_tf (121 rows
of the 11^2 grid, padded to 122), the rollout evaluation of vorticity,
``infer`` on per-sample meshes; and ``sequence_shard_geometry``'s slabs
against the JAX package's padded rows on its 8 fake CPU devices.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import savemat

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.models.pit_tf import TFGeometry
from position_induced_transformer_torch.parallel import (
    DataMesh,
    sequence_shard_geometry,
    sequence_shard_tf_geometry,
)
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.parallel import make_mesh as j_make_mesh
from position_induced_transformer_tpu.parallel import sequence_shard_geometry as j_shard_geometry
from position_induced_transformer_tpu.train import benchmarks as j_bench
from tests.torch_ranks import run_ranks

NARROW = ["model.hid_dim=16", "model.n_blocks=2"]
# label -> (name, overrides, training's arguments, evaluate's arguments)
CASES = {
    "burgers": ("burgers", ["grid=64", "latent_grid=16", "batch_size=8"] + NARROW,
                dict(ntrain=16, ntest=11), dict(ntest=11, shuffle_ablation=True)),
    "darcy_zssr": ("darcy", ["batch_size=8"] + NARROW,
                   dict(ntrain=16, ntest=8, setup_kwargs={"downsampling": 40}),
                   dict(ntest=8, zssr=True, zssr_downsampling=40)),
    "darcy_tf_zssr": ("darcy_tf", ["latent_grid=4,4", "batch_size=8"] + NARROW,
                      dict(ntrain=16, ntest=8, setup_kwargs={"downsampling": 40}),
                      dict(ntest=8, zssr=True, zssr_downsampling=40)),
    "vorticity": ("vorticity", ["grid=16,16", "latent_grid=8,8", "rollout_steps=3", "memory=4",
                                "batch_size=8", "model.in_dim=4", "ntrain=16"] + NARROW,
                  dict(ntrain=16, ntest=11), dict(ntest=11)),
}
ELASTICITY = ["batch_size=4"] + NARROW
MESH_KW = {"n_points": 48}


def _cfg(name, overrides):
    return t_configs.apply_overrides(t_configs.get(name), overrides)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Checkpoints trained in one process, then every case evaluated (and
    elasticity inferred) at data=2 in one pair of ranks: label -> each
    rank's result, and the paths."""
    d = tmp_path_factory.mktemp("eval")
    ns = str(d / "ns_16.mat")  # vorticity's 16^2 trajectories, the real file's layout
    savemat(ns, {"u": t_syn.vorticity(n=27, s=16, frames=7, seed=2)})
    ckpts = {}
    for label, (name, overrides, train_kw, _) in CASES.items():
        ckpts[label] = str(d / f"{label}.pt")
        data_path = ns if name == "vorticity" else None
        t_runner.train(_cfg(name, overrides), data_path, epochs=1, verbose=False, device="cpu",
                       checkpoint_path=ckpts[label], **train_kw)
    ckpts["elasticity"] = str(d / "elasticity.pt")
    problem, _, _ = t_runner.train(_cfg("elasticity", ELASTICITY), epochs=1, ntrain=8, ntest=4,
                                   verbose=False, device="cpu", setup_kwargs=MESH_KW,
                                   checkpoint_path=ckpts["elasticity"])
    savemat(d / "inp.mat", {k: np.asarray(problem.test_data[k])[:3] for k in ("x", "mesh")})
    tmp = run_ranks(d, f"""
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.train import evaluate
        out = {{}}
        for label, (name, overrides, _, kw) in {CASES!r}.items():
            cfg = configs.apply_overrides(configs.get(name), overrides)
            data_path = {ns!r} if name == "vorticity" else None
            out[label] = evaluate.evaluate(cfg, {ckpts!r}[label], data_path, device="cpu",
                                           mesh="data=2", **kw)
        cfg = configs.apply_overrides(configs.get("elasticity"), {ELASTICITY!r})
        out["infer"] = evaluate.infer(cfg, {ckpts["elasticity"]!r}, {str(d / "inp.mat")!r},
                                      output_path=os.path.join(tmp, f"p{{rank}}.npy"),
                                      setup_kwargs={MESH_KW!r}, device="cpu", mesh="data=2")
        torch.save(out, os.path.join(tmp, f"rank{{rank}}.pt"))
    """)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)], ckpts, ns, d, tmp


def _single(label, ckpts, ns):
    name, overrides, _, kw = CASES[label]
    return t_eval.evaluate(_cfg(name, overrides), ckpts[label], ns if name == "vorticity" else None,
                           device="cpu", **kw)


def _assert_same_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_metrics(got[k], v)
        elif isinstance(v, (float, list)):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("label", list(CASES))
def test_evaluate_with_a_mesh_matches_single_process(runs, label):
    """tests/test_parallel.py:685 (data-parallel metrics; here with the
    shuffle ablation and an 11-sample test split: a padded tail), :634 and
    :660 (ZSSR sequence parallel: every rank decodes its slab of the 121
    query rows, padded to 122, on the whole batch; Darcy on kernel #1's
    decoder, darcy_tf on #13's), and the rollout evaluation of vorticity
    (11 windows rolled 3 steps, data-parallel): every rank's metrics equal
    the single-process evaluation's at rtol 1e-5."""
    ranks, ckpts, ns, _, _ = runs
    want = _single(label, ckpts, ns)
    for got in ranks:
        _assert_same_metrics(got[label], want)


def test_infer_with_a_mesh_on_per_sample_meshes(runs):
    """tests/test_parallel.py:708: ``infer`` on elasticity's ``.mat`` of
    ``x`` and ``mesh`` (3 samples, batch 4 shared out over the ranks)
    against one process; only rank 0 writes the output."""
    ranks, ckpts, _, d, tmp = runs
    want = t_eval.infer(_cfg("elasticity", ELASTICITY), ckpts["elasticity"], str(d / "inp.mat"),
                        output_path=str(d / "p.npy"), setup_kwargs=MESH_KW, device="cpu")
    assert ranks[0]["infer"]["pred_shape"] == ranks[1]["infer"]["pred_shape"] == want["pred_shape"]
    assert not os.path.exists(os.path.join(tmp, "p1.npy"))
    np.testing.assert_allclose(np.load(os.path.join(tmp, "p0.npy")), np.load(d / "p.npy"),
                               rtol=1e-5, atol=1e-6)


def test_sequence_shard_geometry_matches_jax():
    """Darcy's 11^2 geometry at data=8: the eight ranks' slabs of ``dist_up``
    and ``thr_up``, concatenated, equal the JAX package's padded rows (121
    rows, 7 repeats of the last) to the bit; the rest of the geometry is
    the whole one. A lazy geometry and a TFGeometry are refused."""
    assert len(jax.devices()) == 8
    jcfg = dataclasses.replace(j_configs.DARCY, model=dataclasses.replace(
        j_configs.DARCY.model, hid_dim=16, n_blocks=2))
    jgeom = j_shard_geometry(j_make_mesh(n_data=8), j_bench.setup_darcy(
        jcfg, ntrain=4, ntest=4, downsampling=40).geom, pad=True)
    tgeom = t_bench.setup(_cfg("darcy", NARROW), ntrain=4, ntest=4, downsampling=40,
                          device="cpu").geom
    slabs = [sequence_shard_geometry(DataMesh(dcn=1, data=8, rank=r), tgeom, pad=True)
             for r in range(8)]
    for name in ("dist_up", "thr_up"):
        got = torch.cat([getattr(g, name) for g in slabs]).numpy()
        assert got.shape[0] == 128
        np.testing.assert_array_equal(got, np.asarray(getattr(jgeom, name)))
    for g in slabs:
        assert g.dist_down is tgeom.dist_down and g.dist_proc is tgeom.dist_proc
    mesh = DataMesh(dcn=1, data=8)
    with pytest.raises(ValueError, match="lazy"):
        sequence_shard_geometry(mesh, dataclasses.replace(tgeom, dist_up=None))
    with pytest.raises(ValueError, match="not divisible"):
        sequence_shard_geometry(mesh, tgeom)
    tf = TFGeometry(m_qry=None, m_cross=torch.rand(121, 16), m_ltt=torch.rand(16, 16))
    with pytest.raises(ValueError, match="sequence_shard_tf_geometry"):
        sequence_shard_geometry(mesh, tf)
    with pytest.raises(ValueError, match="self-attention"):
        sequence_shard_tf_geometry(mesh, tf._replace(m_qry=torch.rand(121, 121)))
    slab = sequence_shard_tf_geometry(DataMesh(dcn=1, data=8, rank=7), tf)
    np.testing.assert_array_equal(slab.m_cross.numpy(),
                                  torch.cat([tf.m_cross[112:], tf.m_cross[-1:].expand(7, 16)]))
    np.testing.assert_array_equal(slab.m_cross_t.numpy(), tf.m_cross.T.numpy())
