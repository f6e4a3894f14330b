"""Deployment inference: a restored checkpoint applied to user batches.

:class:`Predictor` holds a checkpoint warm on one device for repeated
calls; :func:`infer` is the one-shot form. Inputs are ``.npy`` or MATLAB
v5 ``.mat`` files laid out like the benchmark's inputs. A benchmark on
per-sample meshes (elasticity) also needs each sample's coordinates: its
input is a ``.mat`` that holds them beside ``x`` (variable ``mesh``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from position_induced_transformer_torch.configs import get
from position_induced_transformer_torch.train import benchmarks
from position_induced_transformer_torch.train import checkpoint as ckpt
from position_induced_transformer_torch.train.runner import padded_batches
from position_induced_transformer_torch.utils.devices import resolve_device


def _load_input(path: str, key: str = "x"):
    """Load a user input batch: ``(x, table)`` where ``table`` is the full
    variable dict of a ``.mat`` file (None for ``.npy``)."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path, allow_pickle=False)), None
    if path.endswith((".h5", ".hdf5")):
        raise ValueError(
            f"{path}: HDF5 input needs h5py, which this package does not "
            "use; send .npy or a MATLAB v5 .mat"
        )
    if not path.endswith(".mat"):
        raise ValueError(f"unsupported input format {path!r} (expected .npy or .mat)")
    from position_induced_transformer_torch.data.loaders import load_mat

    d = load_mat(path)
    if key not in d:
        raise KeyError(
            f"variable {key!r} not found in {path}; available: "
            f"{sorted(k for k in d if not k.startswith('__'))}"
        )
    return np.asarray(d[key]), d


def _prepare_inputs(problem, x: np.ndarray) -> np.ndarray:
    """Check a raw input batch against the benchmark's model input layout,
    reshaping when the per-sample element counts agree."""
    x = np.asarray(x, np.float32)
    expect = tuple(np.shape(problem.test_data["x"])[1:])
    if x.shape[1:] != expect:
        if int(np.prod(x.shape[1:])) != int(np.prod(expect)):
            raise ValueError(
                f"input sample shape {tuple(x.shape[1:])} does not match "
                f"the benchmark's model input {expect}"
            )
        x = x.reshape((x.shape[0],) + expect)
    return np.ascontiguousarray(x)


class _AccessRecorder(dict):
    """A batch dict that records the keys read with ``batch[k]``;
    ``batch.get(k)`` goes through dict's own lookup and is not recorded,
    which is the required/optional split the geometry builders follow."""

    def __init__(self, base):
        super().__init__(base)
        self.hard = set()

    def __getitem__(self, k):
        self.hard.add(k)
        return super().__getitem__(k)


def _required_geometry_keys(problem) -> set:
    """The batch variables besides ``x`` that the benchmark's per-sample
    geometry cannot do without: ``Task.geometry_required_keys`` where it is
    declared, else found by probing ``geom_fn`` on one test sample."""
    task = problem.task
    if task.geometry_required_keys is not None:
        return set(task.geometry_required_keys)
    if task.geom_fn is None:
        return set()
    dev = next(task.model.parameters()).device
    probe = _AccessRecorder(
        {k: torch.from_numpy(np.asarray(v)[:1]).to(dev) for k, v in problem.test_data.items()}
    )
    task.geom_fn(probe)
    return probe.hard - {"x", "y"}


def _prepare_infer_data(problem, x, table, input_path: str, input_key: str, required=None) -> dict:
    """The inference batch dict of a raw input: ``x`` in the model's layout
    and, for per-sample geometry, the benchmark's other variables from the
    parsed ``.mat`` ``table`` (None for ``.npy``). Required variables (the
    coordinates) must be there; optional ones (precomputed thresholds and
    bands) are taken when present, and computed per step otherwise."""
    data = {"x": _prepare_inputs(problem, x)}
    n = int(data["x"].shape[0])
    extra = [k for k in problem.test_data if k not in ("x", "y")]
    if not extra:
        return data
    if required is None:
        required = _required_geometry_keys(problem)
    if table is None and required:
        raise ValueError(
            f"benchmark {problem.config.name!r} builds per-sample geometry "
            f"from the batch variables {sorted(required)}; send a .mat holding "
            f"them beside {input_key!r} (a bare .npy carries one array only)"
        )
    for k in extra:
        if table is None or k not in table:
            if k in required:
                raise ValueError(
                    f"input file {input_path} is missing the required variable "
                    f"{k!r} (benchmark {problem.config.name!r} takes "
                    f"{['x'] + extra})"
                )
            continue
        ref = np.asarray(problem.test_data[k])
        arr = np.asarray(table[k], ref.dtype)
        expect = (n,) + ref.shape[1:]
        if arr.shape != expect:
            raise ValueError(
                f"input variable {k!r} has shape {tuple(arr.shape)}, expected {expect}"
            )
        data[k] = np.ascontiguousarray(arr)
    return data


class Predictor:
    """A restored checkpoint held warm on ``device`` for repeated inference.

    The benchmark problem (geometry on the device, a minimal synthetic data
    split for layouts) is built once, and the batch variables its
    per-sample geometry requires are found once; each ``predict_*`` call
    moves its batches to the device and back.
    """

    def __init__(
        self,
        config,
        checkpoint_path: str,
        data_path: Optional[str] = None,
        device="cuda",
    ):
        dev = resolve_device(device)
        cfg = get(config) if isinstance(config, str) else config
        restored = ckpt.restore(checkpoint_path)
        if restored["config"] != cfg.name:
            raise ValueError(
                f"checkpoint {checkpoint_path!r} holds benchmark "
                f"{restored['config']!r}, not {cfg.name!r}"
            )
        nmin = max(2, min(cfg.batch_size, 8))
        problem = benchmarks.setup(
            cfg, data_path, ntrain=nmin, ntest=nmin, device=dev
        )
        problem.model.load_state_dict(restored["state_dict"])
        problem.model.eval()
        problem.train_data = {}
        self.cfg = cfg
        self.problem = problem
        self.device = dev
        self.required_keys = frozenset(_required_geometry_keys(problem))

    def _batch_size(self, batch_size: Optional[int] = None) -> int:
        """The device batch size: requests pad up to it, so every call runs
        at one shape."""
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return batch_size or self.cfg.eval_batch_size or self.cfg.batch_size

    def predict_array(self, data: dict, batch_size: Optional[int] = None) -> np.ndarray:
        """Predictions over a prepared batch dict (padded-tail batching:
        every sample covered, one batch shape); every variable of the dict
        is gathered per batch."""
        n = int(np.shape(data["x"])[0])
        bs = self._batch_size(batch_size)
        task, geom = self.problem.task, self.problem.geom
        outs = []
        with torch.inference_mode():
            for idx in padded_batches(n, bs):
                batch = {
                    k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[idx])).to(self.device)
                    for k, v in data.items()
                }
                outs.append(task.forward(geom, batch).cpu().numpy())
        return np.concatenate(outs, axis=0)[:n]

    def prepare_file(self, input_path: str, input_key: str = "x") -> dict:
        """Parse and check an input file into the dict ``predict_array``
        takes."""
        x_raw, table = _load_input(input_path, input_key)
        if x_raw.ndim < 2:
            raise ValueError(
                f"input must carry a leading batch axis; got shape "
                f"{tuple(x_raw.shape)}"
            )
        if x_raw.shape[0] < 1:
            raise ValueError("input batch is empty (0 samples)")
        return _prepare_infer_data(
            self.problem, x_raw, table, input_path, input_key, required=self.required_keys
        )

    def predict_file(
        self, input_path: str, input_key: str = "x",
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        return self.predict_array(self.prepare_file(input_path, input_key), batch_size)


def infer(
    config,
    checkpoint_path: str,
    input_path: str,
    input_key: str = "x",
    output_path: Optional[str] = None,
    batch_size: Optional[int] = None,
    data_path: Optional[str] = None,
    device="cuda",
) -> dict:
    """One-shot inference on an input file; writes ``.npy`` or ``.mat``
    (variable ``pred``) when ``output_path`` is given."""
    if output_path and not output_path.endswith((".npy", ".mat")):
        raise ValueError(
            f"unsupported output format {output_path!r} (expected .npy or .mat)"
        )
    predictor = Predictor(config, checkpoint_path, data_path=data_path, device=device)
    pred = predictor.predict_file(input_path, input_key, batch_size=batch_size)
    if output_path and output_path.endswith(".npy"):
        np.save(output_path, pred)
    elif output_path:
        from scipy.io import savemat

        savemat(output_path, {"pred": pred})
    return {
        "benchmark": predictor.cfg.name,
        "n": int(pred.shape[0]),
        "pred_shape": [int(s) for s in pred.shape],
        "output": output_path,
    }
