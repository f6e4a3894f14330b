"""Per-benchmark problem setup: data -> meshes -> Geometry -> model -> Task.

Ported: ``burgers`` (a fixed periodic mesh), ``sod`` (a fixed 1-D mesh on
[-5, 5)), ``darcy`` (a fixed 2-D grid with per-pixel normalization, at
any ``downsampling`` of the 421^2 grid), ``vorticity`` (a fixed periodic
2-D grid, trained by 20-step rollouts), ``cylinder`` (a fixed 2-D point
cloud, one-step pairs of wake trajectories, evaluated by closed-loop
rollouts), ``elasticity`` (per-sample point clouds), ``naca`` (per-sample
airfoil shapes onto per-sample C-grids), ``elasticity_tf`` (the
TF-semantics point-cloud model) and the TF-semantics fixed-mesh family
(``burgers_tf``, ``sod_tf``, ``darcy_tf``, ``vorticity_tf``, ``naca_tf``:
``PiTTF`` over precomputed distance matrices, keras Adam, the batch-mean
loss). :func:`register_setup` adds user-defined benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from position_induced_transformer_torch.configs import BenchmarkConfig
from position_induced_transformer_torch.data import loaders, meshes
from position_induced_transformer_torch.kernels.posatt_batched import BandSpec, band_tile_rows
from position_induced_transformer_torch.models import (
    Geometry,
    PiT,
    PiTTF,
    PiTTFPointCloud,
    TFGeometry,
    build_geometry,
    build_geometry_host,
    pairwise_dist_half,
    pairwise_dist_periodic_1d,
    pairwise_dist_periodic_2d,
    tf_precompute_thresholds,
)
from position_induced_transformer_torch.ops.distances import euclidean_sq
from position_induced_transformer_torch.ops.locality import (
    batched_band_starts,
    batched_halfdist_percentile_thresholds,
    batched_topk_thresholds,
)
from position_induced_transformer_torch.ops.normalization import PixelWiseNormalizer
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
    # per-pixel statistics of a normalizing benchmark (darcy): x is
    # normalized in the data, the Task's postprocess denormalizes outputs
    x_normalizer: Optional[PixelWiseNormalizer] = None
    y_normalizer: Optional[PixelWiseNormalizer] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


# model_variant -> (processor_attention, coder_attention) of the TF family:
# the reference's ablation baselines, each experiment's PiT with attention
# modules swapped (reference: tensorflow/1_InviscidBurgers/train.py:38-40)
_VARIANT_ATTENTION = {
    "pit": ("position", "position"),
    "lite": ("self", "position"),
    "transformer": ("self", "self"),
    "selfpit": ("hybrid", "hybrid"),
}

# the fixed-mesh TF family: (bandwidth, decoder self-attention)
TF_FIXED = {
    "burgers_tf": ("tan_sin", True),
    "sod_tf": ("square", True),
    "darcy_tf": ("tan_sin", False),
    "vorticity_tf": ("tan_sin", False),
    "naca_tf": ("tan", False),
}


def _variant_attention(cfg: BenchmarkConfig, point_cloud: bool = False) -> dict:
    """The attention kinds and compute type of a TF-family model, from the
    config's ``model_variant``, checked against the benchmark: ``selfpit``
    needs a fixed mesh whose latent grid is its query grid."""
    v = cfg.model_variant or "pit"
    if v not in _VARIANT_ATTENTION:
        raise ValueError(
            f"unknown model variant {v!r}; available: {sorted(_VARIANT_ATTENTION)}"
        )
    if point_cloud and v == "selfpit":
        raise ValueError(
            "the 'selfpit' variant is not defined for the point-cloud "
            "family (the reference has no SelfPiT in 5_Elasticity)"
        )
    if v == "selfpit" and (
        cfg.grid is None or cfg.latent_grid is None or tuple(cfg.grid) != tuple(cfg.latent_grid)
    ):
        raise ValueError(
            "the 'selfpit' variant requires latent == query resolution "
            "(its hybrid attention mixes dot-product logits with the "
            "distance bias; reference SelfPiT lives in "
            "tensorflow/1_InviscidBurgers where ltt_res == qry_res)"
        )
    pa, ca = _VARIANT_ATTENTION[v]
    return {"processor_attention": pa, "coder_attention": ca,
            "compute_dtype": cfg.model.compute_dtype}


def _make_model(cfg: BenchmarkConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The benchmark's model on the CPU, weights drawn from ``generator``:
    the TF-semantics point-cloud model for ``elasticity_tf``, ``PiTTF`` for
    the fixed-mesh TF family, PiT for the torch family."""
    m = cfg.model
    if cfg.name == "elasticity_tf":
        return PiTTFPointCloud(
            in_dim=m.in_dim, out_dim=m.out_dim, hid_dim=m.hid_dim, n_head=m.n_head,
            locality_encoder=m.en_loc, locality_decoder=m.de_loc, n_blocks=m.n_blocks,
            generator=generator, **_variant_attention(cfg, point_cloud=True),
        )
    if cfg.name in TF_FIXED:
        bandwidth, selfatt = TF_FIXED[cfg.name]
        return PiTTF(
            in_dim=m.space_dim + m.in_dim, out_dim=m.out_dim, hid_dim=m.hid_dim,
            n_head=m.n_head, locality_encoder=m.en_loc, locality_decoder=m.de_loc,
            n_blocks=m.n_blocks, bandwidth=bandwidth, use_decoder_selfatt=selfatt,
            generator=generator, **_variant_attention(cfg),
        )
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


def nonneg_bandwidths(model: nn.Module) -> None:
    """Project every ``band_width`` parameter onto [0, inf) in place: keras'
    NonNeg constraint, which the TF family's NACA experiment puts on its
    ``tan`` bandwidth and the ``selfpit`` variant on its hybrid attention's
    (reference: tensorflow/1_InviscidBurgers/utils.py:437), applied after
    each optimizer update (``Task.param_constraint``)."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "band_width":
            p.clamp_(min=0.0)


def _task_kwargs(cfg: BenchmarkConfig) -> dict:
    """The Task fields that a TF-family model variant sets: ``selfpit``'s
    NonNeg projection of every ``band_width``."""
    if (cfg.model_variant or "pit") == "selfpit":
        return {"param_constraint": nonneg_bandwidths}
    return {}


def setup_burgers(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *,
    device="cuda",
) -> Problem:
    """Burgers on a periodic 1-D mesh. Data stay on the host; the geometry
    (built on the host, as every fixed-mesh setup builds it:
    ``build_geometry_host``) and the model (weights from
    ``torch.Generator`` seeded with ``cfg.seed``) live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    x_tr, y_tr, x_te, y_te = loaders.burgers(
        data_path, ntrain, ntest, L=(cfg.grid or (1024,))[0]
    )
    mesh = meshes.grid_1d(x_tr.shape[1])
    mesh_ltt = meshes.grid_1d(cfg.latent_grid[0])
    geom = build_geometry_host(
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


def setup_sod(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *,
    device="cuda",
) -> Problem:
    """The shock tube on a fixed 1-D mesh over ``cfg.domain`` ([-5, 5)),
    Euclidean distances, inputs and outputs (rho, u, p). Data stay on the
    host; the geometry and the model live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    x_tr, y_tr, x_te, y_te = loaders.sod(
        data_path, ntrain, ntest, L=(cfg.grid or (1024,))[0]
    )
    lo, hi = cfg.domain
    mesh = meshes.grid_1d(x_tr.shape[1], lo, hi)
    mesh_ltt = meshes.grid_1d(cfg.latent_grid[0], lo, hi)
    geom = build_geometry_host(
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


def darcy_geometry(cfg: BenchmarkConfig, s: int, device="cuda") -> Geometry:
    """The Darcy geometry at resolution s, built on the host and uploaded to
    ``device``: the s x s grid on [0, 1]^2 (endpoints included) to the
    latent grid and back. Training takes s = 43; the zero-shot
    super-resolution evaluation rebinds the same weights to s = 421
    (177,241 points)."""
    mesh = meshes.grid_2d(s).reshape(-1, 2)
    mesh_ltt = meshes.grid_2d(cfg.latent_grid[0]).reshape(-1, 2)
    return build_geometry_host(
        mesh, mesh_ltt, mesh, metric=cfg.metric,
        en_loc=cfg.model.en_loc, de_loc=cfg.model.de_loc, device=device,
    )


def setup_darcy(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, downsampling=10,
    normalizers=None, *, device="cuda",
) -> Problem:
    """Darcy flow on the s x s grid, s = 420 / ``downsampling`` + 1 (43 at
    10, 421 at 1). ``normalizers``: an ``(x_norm, y_norm)`` pair fitted at
    the training resolution (from a checkpoint); without it both are fitted
    on this training split. x is normalized on the host, and the Task's
    postprocess denormalizes the (B, s*s, 1) output as an (B, s, s, 1)
    grid on the device, with the statistics resized where s differs from
    theirs. Targets stay raw grids."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    train_path = test_path = None
    if data_path:
        train_path = f"{data_path}/piececonst_r421_N1024_smooth1.mat"
        test_path = f"{data_path}/piececonst_r421_N1024_smooth2.mat"
    x_tr, y_tr, x_te, y_te = loaders.darcy(
        train_path, test_path, downsampling, ntrain, ntest
    )
    s = x_tr.shape[1]
    if normalizers is not None:
        x_norm, y_norm = normalizers
    else:
        x_norm = PixelWiseNormalizer.fit(torch.from_numpy(x_tr))
        y_norm = PixelWiseNormalizer.fit(torch.from_numpy(y_tr))
    x_tr_n, x_te_n = (x_norm.normalize(torch.from_numpy(a)).numpy() for a in (x_tr, x_te))

    geom = darcy_geometry(cfg, s, device=dev)
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)

    def denorm(out):  # (B, s*s, C) -> a denormalized (B, s, s, C) grid
        return y_norm.denormalize(out[:, : s * s].reshape(out.shape[0], s, s, -1))

    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=cfg.model.out_dim,
        swap_loss_args=cfg.swap_loss_args, postprocess=denorm,
    )
    flat = lambda a: np.ascontiguousarray(a.reshape(a.shape[0], -1, a.shape[-1]))
    return Problem(
        cfg, model, task, geom,
        {"x": flat(x_tr_n), "y": y_tr}, {"x": flat(x_te_n), "y": y_te},
        ntrain, ntest, x_normalizer=x_norm, y_normalizer=y_norm,
        extras={"s": s, "downsampling": downsampling},
    )


def setup_vorticity(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *,
    device="cuda",
) -> Problem:
    """Vorticity on the periodic s x s grid (endpoints excluded) down to
    the periodic latent grid: inputs are windows of ``cfg.memory`` frames,
    targets the next ``cfg.rollout_steps`` frames, both flattened to (n,
    s*s, frames). The Task rolls the model out over the targets and sums
    its per-step losses. Data stay on the host; the geometry and the model
    live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    x_tr, y_tr, x_te, y_te = loaders.vorticity(
        data_path, ntrain, ntest, cfg.memory, cfg.rollout_steps
    )
    s = x_tr.shape[1]
    mesh = meshes.grid_2d(s, endpoint=False).reshape(-1, 2)
    mesh_ltt = meshes.grid_2d(cfg.latent_grid[0], endpoint=False).reshape(-1, 2)
    geom = build_geometry_host(
        mesh, mesh_ltt, mesh, metric=cfg.metric,
        en_loc=cfg.model.en_loc, de_loc=cfg.model.de_loc, device=dev,
    )
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)
    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=cfg.model.out_dim,
        swap_loss_args=cfg.swap_loss_args, rollout_steps=cfg.rollout_steps,
        trajectory_loss=cfg.trajectory_loss,
    )
    flat = lambda a: np.ascontiguousarray(a.reshape(a.shape[0], s * s, a.shape[-1]))
    return Problem(
        cfg, model, task, geom,
        {"x": flat(x_tr), "y": flat(y_tr)}, {"x": flat(x_te), "y": flat(y_te)},
        ntrain, ntest, extras={"s": s},
    )


def setup_cylinder(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, n_points=4390,
    n_latent=896, *, device="cuda",
) -> Problem:
    """The wake behind a cylinder on one fixed 2-D point cloud (4390
    vertices down to an 896-point latent cloud), Euclidean distances. Each
    trajectory gives 10 one-step pairs: trajectories are requested by that
    count and the pairs trimmed to exactly ``ntrain`` and ``ntest`` (a file
    with another frame count gives another count per trajectory). The raw
    test trajectories ride in ``extras["test_trajectories"]`` for
    :func:`evaluate`'s closed-loop rollout, the plot triangles in
    ``extras["elements"]``. ``n_points`` and ``n_latent`` size the
    synthetic cloud. Data stay on the host; the geometry and the model
    live on ``device``."""
    dev = resolve_device(device)
    ntrain_req, ntest_req = ntrain or cfg.ntrain, ntest or cfg.ntest
    paths, elements_path = (None,) * 4, None
    if data_path:
        paths = tuple(f"{data_path}/{f}" for f in (
            "WakeCylinder_train.mat", "WakeCylinder_test.mat", "vertices.csv",
            "vertices_small.csv"))
        elements_path = f"{data_path}/elements.csv"
    x_tr, y_tr, x_te, y_te, mesh, mesh_ltt, test_traj, elements = loaders.cylinder(
        *paths, ntrain=max(1, -(-ntrain_req // 10)), ntest=max(1, -(-ntest_req // 10)),
        n_points=n_points, n_latent=n_latent, elements_path=elements_path,
    )
    x_tr, y_tr = x_tr[:ntrain_req], y_tr[:ntrain_req]
    x_te, y_te = x_te[:ntest_req], y_te[:ntest_req]
    geom = build_geometry_host(
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
        {"x": x_tr, "y": y_tr}, {"x": x_te, "y": y_te}, x_tr.shape[0], x_te.shape[0],
        extras={"test_trajectories": test_traj, "elements": elements},
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


def setup_naca(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *,
    device="cuda",
) -> Problem:
    """NACA on per-sample meshes: each sample's airfoil shape points (``x``,
    also the encoder's source cloud ``mesh_in``) onto a latent cloud, the
    strided slice ``X[:, ::4, ::4][:, :56, :13]`` of its own C-grid, and
    back out to the whole C-grid (``mesh_out``, 221 x 51 = 11,271 points).

    The meshes are constant across training, so the per-row thresholds are
    data: computed here on ``device`` (``thr_down`` and ``thr_up``). The
    C-grid's index order is spatially coherent, so each 256-row tile of the
    decoder keeps a narrow range of latent columns: a plain (not circular)
    band ``band_up`` with one width shared by both splits. The encoder has
    no band. A batch without the thresholds (a deployment input) has them
    computed per step. Data stay on the host; the model lives on
    ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    c_tr, X_tr, Y_tr, c_te, X_te, Y_te = loaders.naca(
        data_path, ntrain, ntest, nx=cfg.grid[0], ny=cfg.grid[1]
    )
    xd = yd = 4  # the latent slice's strides
    x_res, y_res = cfg.latent_grid
    m = cfg.model
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def prep(coords, X, Y):
        ltt = X[:, ::xd, ::yd, :][:, :x_res, :y_res, :].reshape(X.shape[0], -1, 2)
        d = {"x": coords, "mesh_in": coords,  # one array
             "mesh_ltt": np.ascontiguousarray(ltt),
             "mesh_out": np.ascontiguousarray(X.reshape(X.shape[0], -1, 2)), "y": Y}
        mesh_in, mesh_ltt, mesh_out = (on_dev(d[k]) for k in ("mesh_in", "mesh_ltt", "mesh_out"))
        thr_down = batched_topk_thresholds(mesh_ltt, mesh_in, m.en_loc, cfg.metric)
        thr_up = batched_topk_thresholds(mesh_out, mesh_ltt, m.de_loc, cfg.metric, chunk=16)
        dev_meshes = (mesh_out, mesh_ltt, thr_up)
        for k, t in (("thr_down", thr_down), ("thr_up", thr_up)):
            if t is not None:
                d[k] = t.cpu().numpy()
        return d, dev_meshes

    (d_tr, m_tr), (d_te, m_te) = prep(c_tr, X_tr, Y_tr), prep(c_te, X_te, Y_te)
    band_width = None
    if "thr_up" in d_tr:
        tlo = band_tile_rows(d_tr["mesh_out"].shape[1])
        band = lambda mm, width=None: batched_band_starts(
            *mm, tlo, cfg.metric, chunk=16, width=width)
        b_tr = band(m_tr)
        b_te = None if b_tr is None else band(m_te, b_tr[1])
        if b_te is not None:
            band_width = max(b_tr[1], b_te[1])
            if b_tr[1] < band_width:  # re-clamp to the common width
                b_tr = band(m_tr, band_width)
            d_tr["band_up"], d_te["band_up"] = b_tr[0].numpy(), b_te[0].numpy()
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)

    def geom_fn(batch):
        g = build_geometry(
            batch["mesh_in"], batch["mesh_ltt"], batch["mesh_out"], metric=cfg.metric,
            en_loc=m.en_loc, de_loc=m.de_loc, device=batch["mesh_in"].device, lazy=True,
        )
        starts = batch.get("band_up")
        return dataclasses.replace(
            g, thr_down=batch.get("thr_down"), thr_up=batch.get("thr_up"),
            band_up=None if starts is None or band_width is None else BandSpec(starts, band_width),
        )

    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=m.out_dim,
        swap_loss_args=cfg.swap_loss_args, geom_fn=geom_fn,
        geometry_required_keys=("mesh_in", "mesh_ltt", "mesh_out"),
    )
    return Problem(cfg, model, task, None, d_tr, d_te, ntrain, ntest)


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


def _tf_fixed_problem(
    cfg: BenchmarkConfig, dists, mesh: np.ndarray, train_data, test_data,
    ntrain, ntest, dev, *, extras=None, x_normalizer=None, y_normalizer=None, **task_kw,
) -> Problem:
    """The Problem of a fixed-mesh TF benchmark: the geometry of ``dists``
    (``m_qry`` or None, ``m_cross``, ``m_ltt``) with its thresholds, its
    PiTTF (weights from ``torch.Generator`` seeded with ``cfg.seed``) on
    ``dev``, called as ``model(geom, mesh, x)`` on the query ``mesh``,
    keras Adam and the batch-mean loss. ``task_kw``: the Task's other
    fields (a postprocess, a parameter constraint, and a rollout's), over
    the model variant's (:func:`_task_kwargs`)."""
    geom = tf_precompute_thresholds(TFGeometry(*dists), cfg.model.en_loc, cfg.model.de_loc)
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)
    mesh_dev = torch.from_numpy(np.ascontiguousarray(mesh)).to(dev)

    def apply_fn(model, geom, batch):
        return model(geom, mesh_dev, batch["x"])

    task = Task(
        model=model, loss_p=cfg.loss_p, out_dim=cfg.model.out_dim,
        swap_loss_args=cfg.swap_loss_args, batch_mean_loss=True, keras_adam=True,
        apply_fn=apply_fn, **{**_task_kwargs(cfg), **task_kw},
    )
    return Problem(cfg, model, task, geom, train_data, test_data, ntrain, ntest,
                   x_normalizer=x_normalizer, y_normalizer=y_normalizer, extras=extras or {})


def setup_burgers_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *, device="cuda",
) -> Problem:
    """TF-family Burgers: PiTTF (``tan_sin`` bandwidth, decoder
    self-attention) over the periodic 1-D distances over 0.25, on the
    data's grid (``cfg.grid`` sizes the synthetic fallback only) and the
    latent grid. The geometry and model live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    Lt = (cfg.latent_grid or (1024,))[0]
    x_tr, y_tr, x_te, y_te = loaders.burgers(
        data_path, ntrain, ntest, L=(cfg.grid or (1024,))[0]
    )
    L = x_tr.shape[1]
    dists = (pairwise_dist_periodic_1d(L, L, dev), pairwise_dist_periodic_1d(L, Lt, dev),
             pairwise_dist_periodic_1d(Lt, Lt, dev))
    return _tf_fixed_problem(cfg, dists, meshes.grid_1d(L), {"x": x_tr, "y": y_tr},
                             {"x": x_te, "y": y_te}, ntrain, ntest, dev)


def setup_sod_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *, device="cuda",
) -> Problem:
    """TF-family shock tube: PiTTF (``r^2`` bandwidth, decoder
    self-attention) over squared distances on the unit 1-D grids of the
    data's length and the latent one; the target is the first variable
    alone. The geometry and model live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    Lt = (cfg.latent_grid or (1024,))[0]
    x_tr, y_tr, x_te, y_te = loaders.sod(
        data_path, ntrain, ntest, L=(cfg.grid or (2048,))[0]
    )
    L = x_tr.shape[1]
    y_tr, y_te = y_tr[..., :1], y_te[..., :1]
    g = lambda n: torch.from_numpy(meshes.grid_1d(n)).to(dev)
    dists = (euclidean_sq(g(L), g(L)), euclidean_sq(g(L), g(Lt)), euclidean_sq(g(Lt), g(Lt)))
    c = np.ascontiguousarray
    return _tf_fixed_problem(cfg, dists, meshes.grid_1d(L), {"x": x_tr, "y": c(y_tr)},
                             {"x": x_te, "y": c(y_te)}, ntrain, ntest, dev)


def setup_darcy_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, downsampling=10,
    normalizers=None, *, device="cuda",
) -> Problem:
    """TF-family Darcy: PiTTF (``tan_sin``, no decoder self-attention) over
    halved squared distances between the s x s grid without its endpoints,
    s = 420 / ``downsampling`` + 1 (43 at 10; 421 at 1, the zero-shot
    super-resolution: a 177,241 x 1,024 ``m_cross``), and the latent grid.
    ``normalizers``: an ``(x_norm, y_norm)`` pair fitted at the training
    resolution (from a checkpoint), else both fitted on this training
    split; x is normalized on the host and the Task's postprocess
    denormalizes the output as an (B, s, s, 1) grid. ``m_qry`` is not built:
    only a decoder self-attention reads it. The geometry and model live on
    ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    train_path = test_path = None
    if data_path:
        train_path = f"{data_path}/piececonst_r421_N1024_smooth1.mat"
        test_path = f"{data_path}/piececonst_r421_N1024_smooth2.mat"
    x_tr, y_tr, x_te, y_te = loaders.darcy(
        train_path, test_path, downsampling, ntrain, ntest
    )
    s = x_tr.shape[1]
    grid_q = meshes.grid_2d(s, endpoint=False).reshape(-1, 2)
    grid_l = torch.from_numpy(
        meshes.grid_2d(cfg.latent_grid[0], endpoint=False).reshape(-1, 2)).to(dev)
    dists = (None, pairwise_dist_half(torch.from_numpy(grid_q).to(dev), grid_l),
             pairwise_dist_half(grid_l, grid_l))
    if normalizers is not None:
        x_norm, y_norm = normalizers
    else:
        x_norm = PixelWiseNormalizer.fit(torch.from_numpy(x_tr))
        y_norm = PixelWiseNormalizer.fit(torch.from_numpy(y_tr))
    x_tr_n, x_te_n = (x_norm.normalize(torch.from_numpy(a)).numpy() for a in (x_tr, x_te))

    def denorm(out):  # (B, s*s, C) -> a denormalized (B, s, s, C) grid
        return y_norm.denormalize(out[:, : s * s].reshape(out.shape[0], s, s, -1))

    flat = lambda a: np.ascontiguousarray(a.reshape(a.shape[0], -1, a.shape[-1]))
    return _tf_fixed_problem(
        cfg, dists, grid_q, {"x": flat(x_tr_n), "y": y_tr}, {"x": flat(x_te_n), "y": y_te},
        ntrain, ntest, dev, postprocess=denorm, x_normalizer=x_norm, y_normalizer=y_norm,
        extras={"s": s, "downsampling": downsampling},
    )


def setup_vorticity_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *, device="cuda",
) -> Problem:
    """TF-family vorticity: PiTTF (``tan_sin``, no decoder self-attention)
    over torus distances (the smallest of five images, squared) between
    the periodic s x s grid and the latent one; windows of ``cfg.memory``
    frames rolled ``cfg.rollout_steps`` steps, one loss over the
    trajectory. The geometry and model live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    x_tr, y_tr, x_te, y_te = loaders.vorticity(
        data_path, ntrain, ntest, cfg.memory, cfg.rollout_steps
    )
    s = x_tr.shape[1]
    grid_q = meshes.grid_2d(s, endpoint=False).reshape(-1, 2)
    on = lambda a: torch.from_numpy(a).to(dev)
    grid_l = on(meshes.grid_2d(cfg.latent_grid[0], endpoint=False).reshape(-1, 2))
    dists = (None, pairwise_dist_periodic_2d(on(grid_q), grid_l),
             pairwise_dist_periodic_2d(grid_l, grid_l))
    flat = lambda a: np.ascontiguousarray(a.reshape(a.shape[0], s * s, a.shape[-1]))
    return _tf_fixed_problem(
        cfg, dists, grid_q, {"x": flat(x_tr), "y": flat(y_tr)},
        {"x": flat(x_te), "y": flat(y_te)}, ntrain, ntest, dev,
        rollout_steps=cfg.rollout_steps, trajectory_loss=cfg.trajectory_loss,
        extras={"s": s},
    )


def setup_naca_tf(
    cfg: BenchmarkConfig, data_path=None, ntrain=None, ntest=None, *, device="cuda",
) -> Problem:
    """TF-family NACA: PiTTF (``tan`` bandwidth, projected onto r >= 0 after
    each update by :func:`nonneg_bandwidths`; no decoder self-attention)
    over halved squared distances between index-space grids, the C-grid's
    (``meshes.grid_2d_rect``, 221 x 51) and the latent one's (111 x 26).
    Inputs are the C-grid's vertex coordinates, the target its Mach field.
    Both quantiles of each row are stored, so the heads' scales may take
    either sign. The geometry and model live on ``device``."""
    dev = resolve_device(device)
    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    _, X_tr, Y_tr, _, X_te, Y_te = loaders.naca(
        data_path, ntrain, ntest, nx=cfg.grid[0], ny=cfg.grid[1], mach=True
    )
    nx, ny = X_tr.shape[1], X_tr.shape[2]
    grid_q = meshes.grid_2d_rect(nx, ny)
    grid_l = torch.from_numpy(meshes.grid_2d_rect(*cfg.latent_grid)).to(dev)
    dists = (None, pairwise_dist_half(torch.from_numpy(grid_q).to(dev), grid_l),
             pairwise_dist_half(grid_l, grid_l))
    flat = lambda a: np.ascontiguousarray(a.reshape(a.shape[0], -1, a.shape[-1]))
    return _tf_fixed_problem(
        cfg, dists, grid_q, {"x": flat(X_tr), "y": flat(Y_tr)},
        {"x": flat(X_te), "y": flat(Y_te)}, ntrain, ntest, dev,
        param_constraint=nonneg_bandwidths,
    )


SETUPS = {
    "burgers": setup_burgers,
    "sod": setup_sod,
    "darcy": setup_darcy,
    "vorticity": setup_vorticity,
    "elasticity": setup_elasticity,
    "naca": setup_naca,
    "cylinder": setup_cylinder,
    "elasticity_tf": setup_elasticity_tf,
    "burgers_tf": setup_burgers_tf,
    "sod_tf": setup_sod_tf,
    "darcy_tf": setup_darcy_tf,
    "vorticity_tf": setup_vorticity_tf,
    "naca_tf": setup_naca_tf,
}
def setup(cfg: BenchmarkConfig, data_path=None, *, device="cuda", **kw) -> Problem:
    try:
        setup_fn = SETUPS[cfg.name]
    except KeyError:
        raise ValueError(
            f"no setup registered for benchmark {cfg.name!r}; register one "
            "with train.benchmarks.register_setup (or "
            "position_induced_transformer_torch.register_benchmark). "
            f"Available: {sorted(SETUPS)}"
        ) from None
    return setup_fn(cfg, data_path, device=device, **kw)


def register_setup(
    name: str, setup_fn: Callable[..., Problem], overwrite: bool = False,
) -> Callable[..., Problem]:
    """Register a user-defined problem setup under ``name``.

    ``setup_fn(cfg, data_path=None, ntrain=None, ntest=None, *,
    device="cuda") -> Problem`` is called by every entry point
    (``runner.train``, ``evaluate``, ``infer``, the server, the command
    line); it puts the geometry and the model on ``device``. Pair it with
    :func:`configs.register`, or use the one call
    ``position_induced_transformer_torch.register_benchmark``.
    """
    if name in SETUPS and not overwrite:
        raise ValueError(
            f"setup {name!r} is already registered; pass overwrite=True "
            "to replace it"
        )
    SETUPS[name] = setup_fn
    return setup_fn
