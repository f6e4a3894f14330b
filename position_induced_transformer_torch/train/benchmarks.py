"""Per-benchmark problem setup: data -> meshes -> Geometry -> model -> Task.

Only ``burgers`` is ported so far; :func:`setup` names the others as not
yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from position_induced_transformer_torch.configs import REGISTRY, BenchmarkConfig
from position_induced_transformer_torch.data import loaders, meshes
from position_induced_transformer_torch.models import Geometry, PiT, build_geometry
from position_induced_transformer_torch.train.loop import Task
from position_induced_transformer_torch.utils.devices import resolve_device


@dataclasses.dataclass
class Problem:
    config: BenchmarkConfig
    model: PiT
    task: Task
    geom: Optional[Geometry]
    train_data: Dict[str, np.ndarray]  # host arrays; batches move per call
    test_data: Dict[str, np.ndarray]
    n_train: int
    n_test: int


def _make_model(cfg: BenchmarkConfig, generator: Optional[torch.Generator] = None) -> PiT:
    """The benchmark's PiT on the CPU, weights drawn from ``generator``."""
    if (cfg.model_variant or "pit") != "pit":
        raise ValueError(
            f"model variant {cfg.model_variant!r} exists for the TF-family "
            "benchmarks only"
        )
    m = cfg.model
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


SETUPS = {"burgers": setup_burgers}


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
