"""Benchmark configurations: the thirteen PiT experiments as data.

The port's own copy of the JAX package's ``configs`` (same fields, same
values), so that the port never imports the JAX package.
``train.benchmarks.setup`` names the configurations without a ported setup;
:func:`register` adds user-defined ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    space_dim: int
    in_dim: int
    out_dim: int
    hid_dim: int
    n_head: int
    n_blocks: int
    en_loc: float
    de_loc: float
    concat_mesh: bool = True
    use_instance_norm: bool = False
    residual_output: bool = False
    # mixed precision: 'bfloat16' runs the activations in bf16; parameters,
    # distances, masks, the softmax, norm statistics and the output stay
    # float32 (models/pit.py); opt in via --set model.compute_dtype=bfloat16
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    name: str
    model: ModelConfig
    metric: str  # 'euclidean' | 'periodic1d' | 'periodic2d'
    ntrain: int
    ntest: int
    batch_size: int
    epochs: int
    lr: float = 1e-3
    warmup_steps: int = 0
    loss_p: int = 2
    eval_batch_size: Optional[int] = None
    rollout_steps: int = 0
    trajectory_loss: bool = False
    memory: int = 0
    swap_loss_args: bool = False
    normalize_x: bool = False
    normalize_y: bool = False
    grid: Optional[Tuple[int, ...]] = None
    latent_grid: Optional[Tuple[int, ...]] = None
    domain: Tuple[float, float] = (0.0, 1.0)
    periodic_grid: bool = False
    seed: int = 0
    model_variant: str = "pit"


BURGERS = BenchmarkConfig(
    name="burgers",
    model=ModelConfig(1, 1, 1, 64, 2, 5, 0.02, 0.02),
    metric="periodic1d",
    ntrain=1024, ntest=128, batch_size=8, epochs=500, loss_p=1,
    grid=(1024,), latent_grid=(256,), periodic_grid=True,
)

SOD = BenchmarkConfig(
    name="sod",
    model=ModelConfig(1, 3, 3, 32, 1, 2, 0.02, 0.02),
    metric="euclidean",
    ntrain=1024, ntest=128, batch_size=8, epochs=500, loss_p=1,
    grid=None, latent_grid=(256,), domain=(-5.0, 5.0), periodic_grid=True,
)

DARCY = BenchmarkConfig(
    name="darcy",
    model=ModelConfig(2, 1, 1, 64, 2, 4, 0.02, 0.02),
    metric="euclidean",
    ntrain=1024, ntest=100, batch_size=8, eval_batch_size=10, epochs=30,
    loss_p=2, normalize_x=True, normalize_y=True,
    grid=(43, 43), latent_grid=(16, 16),
)

VORTICITY = BenchmarkConfig(
    name="vorticity",
    model=ModelConfig(2, 10, 1, 256, 2, 4, 0.02, 0.02, use_instance_norm=True),
    metric="periodic2d",
    ntrain=1000, ntest=200, batch_size=20, epochs=500, loss_p=2,
    rollout_steps=20, memory=10, swap_loss_args=True,
    grid=(64, 64), latent_grid=(16, 16), periodic_grid=True,
)

ELASTICITY = BenchmarkConfig(
    name="elasticity",
    model=ModelConfig(2, 44, 1, 256, 2, 4, 0.02, 0.02, concat_mesh=False),
    metric="euclidean",
    ntrain=1000, ntest=200, batch_size=10, epochs=500, loss_p=2,
)

NACA = BenchmarkConfig(
    name="naca",
    model=ModelConfig(2, 2, 4, 128, 1, 4, 0.02, 0.02, concat_mesh=False),
    metric="euclidean",
    ntrain=1000, ntest=200, batch_size=20, epochs=500, loss_p=2,
    grid=(221, 51), latent_grid=(56, 13),
)

CYLINDER = BenchmarkConfig(
    name="cylinder",
    model=ModelConfig(2, 3, 3, 256, 1, 4, 0.01, 0.01, residual_output=True),
    metric="euclidean",
    ntrain=10000, ntest=1000, batch_size=200, epochs=500, loss_p=2,
    swap_loss_args=True,
)

# TF-semantics family: locality values are percentiles in [0, 100]
BURGERS_TF = BenchmarkConfig(
    name="burgers_tf",
    model=ModelConfig(1, 1, 1, 64, 2, 4, en_loc=1.0, de_loc=8.0),
    metric="periodic1d",
    ntrain=950, ntest=128, batch_size=5, epochs=500, loss_p=1,
    eval_batch_size=128,
    grid=(1024,), latent_grid=(1024,), periodic_grid=True,
)

DARCY_TF = BenchmarkConfig(
    name="darcy_tf",
    model=ModelConfig(2, 1, 1, 128, 2, 4, en_loc=2.0, de_loc=5.0),
    metric="euclidean",
    ntrain=1024, ntest=100, batch_size=8, epochs=500, loss_p=2,
    normalize_x=True, normalize_y=True,
    grid=(43, 43), latent_grid=(32, 32),
)

SOD_TF = BenchmarkConfig(
    name="sod_tf",
    model=ModelConfig(1, 3, 1, 64, 2, 4, en_loc=4.0, de_loc=2.0),
    metric="euclidean",
    ntrain=1024, ntest=128, batch_size=8, epochs=500, loss_p=1,
    grid=(2048,), latent_grid=(1024,),
)

VORTICITY_TF = BenchmarkConfig(
    name="vorticity_tf",
    model=ModelConfig(2, 10, 1, 256, 1, en_loc=1.0, de_loc=8.0, n_blocks=4),
    metric="periodic2d",
    ntrain=1000, ntest=200, batch_size=8, epochs=500, loss_p=2,
    rollout_steps=20, trajectory_loss=True, memory=10,
    grid=(64, 64), latent_grid=(16, 16), periodic_grid=True,
)

ELASTICITY_TF = BenchmarkConfig(
    name="elasticity_tf",
    model=ModelConfig(2, 44, 1, 512, 8, 4, en_loc=2.0, de_loc=2.0,
                      concat_mesh=False),
    metric="euclidean",
    ntrain=1000, ntest=200, batch_size=10, epochs=500, loss_p=2,
)

NACA_TF = BenchmarkConfig(
    name="naca_tf",
    model=ModelConfig(2, 2, 1, 256, 2, 4, en_loc=0.5, de_loc=2.0),
    metric="euclidean",
    ntrain=1000, ntest=200, batch_size=8, epochs=500, loss_p=2,
    grid=(221, 51), latent_grid=(111, 26),
)

REGISTRY = {
    c.name: c
    for c in (
        BURGERS, SOD, DARCY, VORTICITY, ELASTICITY, NACA, CYLINDER,
        BURGERS_TF, SOD_TF, DARCY_TF, VORTICITY_TF, ELASTICITY_TF, NACA_TF,
    )
}
BUILTIN = frozenset(REGISTRY)


def get(name: str) -> BenchmarkConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown benchmark {name!r}; available: {sorted(REGISTRY)}"
        ) from None


def register(cfg: BenchmarkConfig, overwrite: bool = False) -> BenchmarkConfig:
    """Register a user-defined benchmark configuration, which then takes
    part in every entry point (``runner.train``, ``evaluate``, ``infer``,
    the server, ``--set`` overrides on the command line) as the built-in
    thirteen do. Pair it with ``train.benchmarks.register_setup``, or use
    the one call ``position_induced_transformer_torch.register_benchmark``.
    """
    if not isinstance(cfg, BenchmarkConfig):
        raise TypeError(f"expected a BenchmarkConfig, got {type(cfg).__name__}")
    if not cfg.name:
        raise ValueError("benchmark config needs a non-empty name")
    if cfg.name in REGISTRY and not overwrite:
        raise ValueError(
            f"benchmark {cfg.name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    REGISTRY[cfg.name] = cfg
    return cfg


def apply_overrides(cfg: BenchmarkConfig, overrides) -> BenchmarkConfig:
    """Apply ``key=value`` overrides to a config.

    Dotted paths reach the nested model config (``model.hid_dim=128``);
    values are parsed by the field's declared type (ints, floats, bools as
    true/false/1/0, comma-separated ints for tuple fields such as
    ``latent_grid=16,16``). Unknown keys raise with the valid names.
    """

    def parse(value: str, ftype) -> object:
        s = str(ftype)
        if ftype is bool or "bool" in s:
            low = value.strip().lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"expected a boolean, got {value!r}")
        if ftype is int or s in ("int", "<class 'int'>"):
            return int(value)
        if ftype is float or "float" in s:
            return float(value)
        if "Tuple" in s or "tuple" in s:
            parts = [p for p in value.split(",") if p.strip() != ""]
            elem = float if "float" in s else int
            return tuple(elem(p) for p in parts)
        if "int" in s:  # Optional[int]
            return int(value)
        return value  # str fields (metric, name, model_variant)

    for item in overrides or ():
        key, sep, value = str(item).partition("=")
        if not sep:
            raise ValueError(
                f"bad override {item!r}; expected key=value "
                "(e.g. model.hid_dim=128, lr=3e-4, latent_grid=16,16)"
            )
        key = key.strip()
        target, attr = cfg, key
        if key.startswith("model."):
            target, attr = cfg.model, key[len("model."):]
        fields = {f.name: f for f in dataclasses.fields(target)}
        if attr not in fields:
            scope = "model." if target is not cfg else ""
            raise ValueError(
                f"unknown config field {key!r}; valid: "
                f"{sorted(scope + n for n in fields)}"
            )
        parsed = parse(value, fields[attr].type)
        if target is cfg:
            cfg = dataclasses.replace(cfg, **{attr: parsed})
        else:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, **{attr: parsed})
            )
    return cfg
