"""Per-benchmark problem setup: data -> meshes -> Geometry -> model -> Task.

Ported: ``burgers`` (a fixed periodic mesh), ``elasticity`` (per-sample
point clouds) and ``elasticity_tf`` (the TF-semantics point-cloud model);
:func:`setup` names the others as not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from position_induced_transformer_torch.configs import REGISTRY, BenchmarkConfig
from position_induced_transformer_torch.data import loaders, meshes
from position_induced_transformer_torch.kernels.posatt_batched import BandSpec, band_tile_rows
from position_induced_transformer_torch.models import Geometry, PiT, PiTTFPointCloud, build_geometry
from position_induced_transformer_torch.ops.locality import (
    batched_band_starts,
    batched_halfdist_percentile_thresholds,
    batched_topk_thresholds,
)
from position_induced_transformer_torch.train.loop import Task
from position_induced_transformer_torch.utils.devices import resolve_device


@dataclasses.dataclass
class Problem:
    config: BenchmarkConfig
    model: nn.Module
    task: Task
    geom: Optional[Geometry]
    train_data: Dict[str, np.ndarray]  # host arrays; batches move per call
    test_data: Dict[str, np.ndarray]
    n_train: int
    n_test: int


def _make_model(cfg: BenchmarkConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The benchmark's model on the CPU, weights drawn from ``generator``:
    the TF-semantics point-cloud model for ``elasticity_tf``, PiT for the
    torch family."""
    m = cfg.model
    if cfg.name == "elasticity_tf":
        if (cfg.model_variant or "pit") != "pit":
            raise NotImplementedError(
                f"model variant {cfg.model_variant!r}: only 'pit' (position "
                "attention) is ported for the TF family"
            )
        return PiTTFPointCloud(
            in_dim=m.in_dim, out_dim=m.out_dim, hid_dim=m.hid_dim, n_head=m.n_head,
            locality_encoder=m.en_loc, locality_decoder=m.de_loc, n_blocks=m.n_blocks,
            compute_dtype=m.compute_dtype, generator=generator,
        )
    if cfg.name.endswith("_tf"):
        raise NotImplementedError(f"the TF-family model of {cfg.name!r} is not ported yet")
    if (cfg.model_variant or "pit") != "pit":
        raise ValueError(
            f"model variant {cfg.model_variant!r} exists for the TF-family "
            "benchmarks only"
        )
    return PiT(
        space_dim=m.space_dim,
        in_dim=m.in_dim,
        out_dim=m.out_dim,
        hid_dim=m.hid_dim,
        n_head=m.n_head,
        n_blocks=m.n_blocks,
        en_loc=m.en_loc,
        de_loc=m.de_loc,
        concat_mesh=m.concat_mesh,
        use_instance_norm=m.use_instance_norm,
        residual_output=m.residual_output,
        compute_dtype=m.compute_dtype,
        generator=generator,
    )


def setup_burgers(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *,
    device="cuda",
) -> Problem:
    """Burgers on a periodic 1-D mesh. Data stay on the host; the geometry
    and the model (weights from ``torch.Generator`` seeded with
    ``cfg.seed``) live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    x_tr, y_tr, x_te, y_te = loaders.burgers(
        data_path, ntrain, ntest, L=(cfg.grid or (1024,))[0]
    )
    mesh = meshes.grid_1d(x_tr.shape[1])
    mesh_ltt = meshes.grid_1d(cfg.latent_grid[0])
    geom = build_geometry(
        mesh, mesh_ltt, mesh, metric=cfg.metric,
        en_loc=cfg.model.en_loc, de_loc=cfg.model.de_loc, device=dev,
    )
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)
    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=cfg.model.out_dim,
        swap_loss_args=cfg.swap_loss_args,
    )
    return Problem(
        cfg, model, task, geom,
        {"x": x_tr, "y": y_tr}, {"x": x_te, "y": y_te}, ntrain, ntest,
    )


def setup_elasticity(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, n_points=972, *,
    device="cuda",
) -> Problem:
    """Elasticity on per-sample point clouds: the latent and output meshes
    are each sample's input cloud, so the Task builds a lazy Geometry from
    the batch's ``mesh`` per step.

    Each cloud is sorted by angle around its centroid (inputs, coordinates
    and targets with one permutation: exact, since attention is
    permutation-equivariant in its keys and the loss is per point). Index
    order then follows the closed curve, and each row tile's kept columns
    form a narrow circular band. With ``en_loc == de_loc < 1`` one set of
    per-row thresholds and band starts serves encoder and decoder: they are
    computed here on ``device`` and ride in the data as ``thr`` and
    ``band``, with one band width shared by both splits. Where no band
    saves work, the data carry neither, and every step computes its
    thresholds. Data stay on the host; the model lives on ``device``.
    """
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    X_tr, ext_tr, Y_tr, X_te, ext_te, Y_te = loaders.elasticity(
        data_path, ntrain, ntest, n_points=n_points
    )
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)

    def sort_split(X, ext, Y):
        perm = meshes.angular_sort_perm(ext)[..., None]
        return tuple(np.take_along_axis(a, perm, axis=1) for a in (X, ext, Y))

    X_tr, ext_tr, Y_tr = sort_split(X_tr, ext_tr, Y_tr)
    X_te, ext_te, Y_te = sort_split(X_te, ext_te, Y_te)
    extras_tr, extras_te = {}, {}
    band_width = band_wrap = None
    loc = cfg.model.en_loc
    if cfg.model.de_loc == loc and loc < 1.0:
        tlo = band_tile_rows(ext_tr.shape[1])
        m_tr, m_te = (torch.from_numpy(np.ascontiguousarray(e)).to(dev) for e in (ext_tr, ext_te))
        thr_tr = batched_topk_thresholds(m_tr, m_tr, loc, cfg.metric)
        thr_te = batched_topk_thresholds(m_te, m_te, loc, cfg.metric)
        b_tr = batched_band_starts(m_tr, m_tr, thr_tr, tlo, cfg.metric, circular=True)
        b_te = None
        if b_tr is not None:
            b_te = batched_band_starts(
                m_te, m_te, thr_te, tlo, cfg.metric, width=b_tr[1], circular=True
            )
        if b_te is not None:
            band_width, band_wrap = max(b_tr[1], b_te[1]), max(b_tr[2], b_te[2])
            if b_tr[1] < band_width:
                b_tr = batched_band_starts(
                    m_tr, m_tr, thr_tr, tlo, cfg.metric, width=band_width, circular=True
                )
            extras_tr = {"thr": thr_tr.cpu().numpy(), "band": b_tr[0].numpy()}
            extras_te = {"thr": thr_te.cpu().numpy(), "band": b_te[0].numpy()}

    def geom_fn(batch):
        # latent mesh == output mesh == the input cloud, per sample
        m = batch["mesh"]
        g = build_geometry(
            m, m, m, metric=cfg.metric, en_loc=cfg.model.en_loc,
            de_loc=cfg.model.de_loc, device=m.device, lazy=True,
        )
        thr, starts = batch.get("thr"), batch.get("band")
        if thr is None or starts is None or band_width is None:
            return g  # a deployment batch: thresholds computed per step
        spec = BandSpec(starts, band_width, band_wrap)
        return dataclasses.replace(g, thr_down=thr, thr_up=thr, band_down=spec, band_up=spec)

    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=cfg.model.out_dim,
        swap_loss_args=cfg.swap_loss_args, geom_fn=geom_fn,
        geometry_required_keys=("mesh",),
    )
    return Problem(
        cfg, model, task, None,
        {"x": X_tr, "mesh": ext_tr, "y": Y_tr, **extras_tr},
        {"x": X_te, "mesh": ext_te, "y": Y_te, **extras_te},
        ntrain, ntest,
    )


def setup_elasticity_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, n_points=972, *,
    device="cuda",
) -> Problem:
    """Elasticity with the TF-semantics point-cloud model: distances
    between the first two input channels, percentile locality.

    Each cloud is sorted by angle (as :func:`setup_elasticity` does). The
    clouds are constant across training, so the per-sample thresholds on
    the halved distances are data: computed here on ``device``
    (``thr_en``, and ``thr_de`` when the decoder's locality differs), with a
    circular band per threshold from ``2 * thr`` on the full squared
    distances and one band width shared by both splits. They ride in the
    data and reach the model through ``geom_fn``; a batch without them (a
    deployment input: ``x`` alone) makes the model compute its thresholds
    per call. Data stay on the host; the model lives on ``device``.
    """
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    X_tr, ext_tr, Y_tr, X_te, ext_te, Y_te = loaders.elasticity(
        data_path, ntrain, ntest, n_points=n_points
    )
    m = cfg.model
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)

    def sort_split(X, ext, Y):
        perm = meshes.angular_sort_perm(ext)[..., None]
        return tuple(np.take_along_axis(a, perm, axis=1) for a in (X, ext, Y))

    splits = [sort_split(X_tr, ext_tr, Y_tr), sort_split(X_te, ext_te, Y_te)]
    data = [{"x": X, "mesh": ext, "y": Y} for X, ext, Y in splits]
    coords = [torch.from_numpy(np.ascontiguousarray(X[..., :2])).to(dev) for X, _, _ in splits]
    tlo = band_tile_rows(splits[0][0].shape[1])
    band_meta = {}  # threshold key -> (width, wrap)
    for key, loc in (("thr_en", m.en_loc), ("thr_de", m.de_loc)):
        if key == "thr_de" and m.de_loc == m.en_loc:
            thrs = [d.get("thr_en") for d in data]
        else:
            thrs = [batched_halfdist_percentile_thresholds(c, loc) for c in coords]
        if thrs[0] is None:
            continue
        for d, t in zip(data, thrs):
            d[key] = t if isinstance(t, np.ndarray) else t.cpu().numpy()
        if key == "thr_de" and "thr_en" in band_meta:
            band_meta["thr_de"] = band_meta["thr_en"]
            for d in data:
                d["band_de"] = d["band_en"]
            continue
        full = [2.0 * torch.from_numpy(d[key]).to(dev) for d in data]
        b_tr = batched_band_starts(coords[0], coords[0], full[0], tlo, circular=True)
        b_te = None if b_tr is None else batched_band_starts(
            coords[1], coords[1], full[1], tlo, width=b_tr[1], circular=True)
        if b_te is None:
            continue
        width, wrap = max(b_tr[1], b_te[1]), max(b_tr[2], b_te[2])
        if b_tr[1] < width:
            b_tr = batched_band_starts(coords[0], coords[0], full[0], tlo, width=width, circular=True)
        bkey = key.replace("thr", "band")
        data[0][bkey], data[1][bkey] = b_tr[0].numpy(), b_te[0].numpy()
        band_meta[key] = (width, wrap)

    def spec(batch, bkey, tkey):
        starts, meta = batch.get(bkey), band_meta.get(tkey)
        return None if starts is None or meta is None else BandSpec(starts, *meta)

    def geom_fn(batch):
        return {
            "thr_en": batch.get("thr_en"), "thr_de": batch.get("thr_de"),
            "band_en": spec(batch, "band_en", "thr_en"),
            "band_de": spec(batch, "band_de", "thr_de"),
        }

    def apply_fn(model, geom, batch):
        g = geom or {}
        return model(batch["x"], g.get("thr_en"), g.get("thr_de"), g.get("band_en"), g.get("band_de"))

    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=m.out_dim, swap_loss_args=cfg.swap_loss_args,
        batch_mean_loss=True, geom_fn=geom_fn, apply_fn=apply_fn, keras_adam=True,
        geometry_required_keys=(),  # the thresholds are optional, the mesh plot-only
    )
    return Problem(cfg, model, task, None, data[0], data[1], ntrain, ntest)


SETUPS = {
    "burgers": setup_burgers,
    "elasticity": setup_elasticity,
    "elasticity_tf": setup_elasticity_tf,
}


def setup(cfg: BenchmarkConfig, data_path=None, *, device="cuda", **kw) -> Problem:
    try:
        setup_fn = SETUPS[cfg.name]
    except KeyError:
        if cfg.name in REGISTRY:
            raise NotImplementedError(
                f"benchmark {cfg.name!r} is not ported to the torch package "
                f"yet; ported: {sorted(SETUPS)}"
            ) from None
        raise ValueError(
            f"no setup for benchmark {cfg.name!r}; available: {sorted(SETUPS)}"
        ) from None
    return setup_fn(cfg, data_path, device=device, **kw)
