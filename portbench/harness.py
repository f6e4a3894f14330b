"""What every cell shares: the manifest and the files it names, the
program's configuration built from a configuration file, the run's
devices, the guard against JAX, and the result line.

Whatever belongs to one configuration, traffic mix, traffic kind,
per-layer metric or cell lives in a file of its own, found by name:

- ``configs/<config>.json``: the configuration as it is run; its
  ``family`` names ``reference/<family>.py`` and ``work/<family>.py``,
  and ``inputs/<config>.py`` makes its inputs;
- ``traffic/<mix>.json``: a traffic mix, whose ``kind`` names the
  general generator ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, or, where
  that file is absent, ``metrics/<stem>.py``, the reader shared by the
  metrics whose names begin with ``<stem>.`` (one quantity split by the
  end-to-end metric it moves, as ``mfu.train`` and ``mfu.infer``);
- ``work/<family>.py``: the operations and bytes of the family's units of
  work, behind one signature (``window_work``) that every traffic kind
  calls without knowing the family;
- ``limits/<workload>.json``: the limits of a cell's comparison with the
  reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "position_induced_transformer_torch"
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "position_induced_transformer_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, overrides: dict | None = None) -> dict:
    """The configuration file ``configs/<name>.json``; ``overrides`` (tests
    only) maps dotted keys to values (``"model.hid_dim": 16``)."""
    cfg = load_json(HERE / "configs" / f"{name}.json")
    for key, value in (overrides or {}).items():
        node, *path = key.split(".")
        target = cfg
        for part in [node, *path][:-1]:
            target = target[part]
        target[[node, *path][-1]] = value
    return cfg


def mix(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, imported by name."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    if name.isidentifier():
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else the
    shared ``metrics/<stem>.py`` of the part of its name before the first
    dot."""
    if (HERE / "metrics" / f"{metric}.py").is_file():
        return module("metrics", metric)
    return module("metrics", metric.split(".")[0])


def program_config(cfg: dict):
    """The program's ``BenchmarkConfig`` of this configuration file: the
    registered configuration of the same name with every field the file
    gives replaced by the file's value (the file is what runs)."""
    from position_induced_transformer_torch import configs

    base = configs.get(cfg["name"])
    model_fields = {f.name for f in dataclasses.fields(base.model)}
    top_fields = {f.name for f in dataclasses.fields(base)}
    unknown = set(cfg["model"]) - model_fields
    if unknown:
        raise ValueError(f"{cfg['name']}: unknown model fields {sorted(unknown)}")
    model = dataclasses.replace(base.model, **cfg["model"])
    top = {k: v for k, v in cfg.items() if k in top_fields and k not in ("name", "model")}
    return dataclasses.replace(base, model=model, **top)


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own libraries under ``build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


@dataclasses.dataclass
class Cell:
    """One run of one workload: its files, the run's arguments, and where
    it may write (``workdir``, under the run's TMPDIR)."""

    workload: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    workdir: str

    @property
    def reference(self):
        return module("reference", self.cfg["family"])

    @property
    def work(self):
        return module("work", self.cfg["family"])

    @property
    def inputs(self):
        return module("inputs", self.cfg["name"])


@dataclasses.dataclass
class Outcome:
    """What a traffic kind reports: end-to-end metrics {name: (value,
    unit)}, units of work attempted and failed, the numbers compared with
    the reference, the peak device memory of the program (before the
    reference ran), the traced window for the per-layer readers, and lines
    for standard error."""

    metrics: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    window: object = None
    notes: list = dataclasses.field(default_factory=list)
