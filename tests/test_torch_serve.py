"""The port's Predictor and HTTP server against the JAX package's
``task.forward``, on the CPU, at a small Burgers size (128 -> 32 -> 128,
hid 16, 2 heads, 2 blocks).

Predictions hold at rtol 1e-4 / atol 1e-5, the model-level bound of
test_torch_model.py (summation order through the stacked layers).
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from position_induced_transformer_torch.utils.torch_compat import (
    flax_params_to_state_dict,
)
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.train import benchmarks as j_bench

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OVERRIDES = ["grid=128", "latent_grid=32", "model.hid_dim=16", "model.n_blocks=2"]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def burgers(tmp_path_factory):
    """JAX-initialised small Burgers weights, saved as a port checkpoint,
    with the JAX forward over 13 synthetic samples as the expected output."""
    j_cfg = j_configs.apply_overrides(j_configs.BURGERS, OVERRIDES)
    problem = j_bench.setup(j_cfg, ntrain=8, ntest=13)
    x = np.array(problem.test_data["x"])
    params = problem.model.init(jax.random.PRNGKey(0), problem.geom, jnp.asarray(x[:1]))["params"]
    want = np.asarray(problem.task.forward(params, problem.geom, {"x": jnp.asarray(x)}))
    path = str(tmp_path_factory.mktemp("ckpt") / "burgers.pt")
    t_ckpt.save(path, flax_params_to_state_dict(params), "burgers")
    cfg = t_configs.apply_overrides(t_configs.BURGERS, OVERRIDES)
    return cfg, path, x, want


@pytest.fixture(scope="module")
def predictor(burgers):
    cfg, path, _, _ = burgers
    return t_eval.Predictor(cfg, path, device="cpu")


@pytest.fixture(scope="module")
def server(burgers):
    cfg, path, _, _ = burgers
    srv = make_server(cfg, path, port=0, verbose=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def _post(url, body, **params):
    from urllib.parse import urlencode

    q = ("?" + urlencode(params)) if params else ""
    req = urllib.request.Request(url + q, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_predictor_matches_jax_forward_with_padded_tail(burgers, predictor):
    _, _, x, want = burgers
    assert predictor._batch_size() == 8  # 13 samples: one full batch, one padded
    got = predictor.predict_array({"x": x})
    assert got.shape == want.shape == (13, 128, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # batch boundaries change nothing
    np.testing.assert_allclose(
        predictor.predict_array({"x": x}, batch_size=5), got, rtol=1e-6, atol=1e-7
    )


def test_padded_batches_and_round_batch():
    batches = list(t_runner.padded_batches(13, 8))
    assert [b.tolist() for b in batches] == [
        list(range(8)), [8, 9, 10, 11, 12, 12, 12, 12]
    ]
    assert t_runner.round_batch(13, 4) == 12
    assert t_runner.round_batch(3, 4) == 4
    assert t_runner.round_batch(7, 1) == 7


def test_infer_and_file_formats(burgers, predictor, tmp_path):
    cfg, path, x, want = burgers
    np.save(tmp_path / "in.npy", x[:3])
    out = t_eval.infer(cfg, path, str(tmp_path / "in.npy"),
                       output_path=str(tmp_path / "out.npy"), device="cpu")
    assert out["pred_shape"] == [3, 128, 1]
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want[:3], rtol=RTOL, atol=ATOL)
    from scipy.io import savemat

    # a flattened (n, L) .mat batch is reshaped to the model's (n, L, 1)
    savemat(tmp_path / "in.mat", {"u": x[:2, :, 0]})
    got = predictor.predict_file(str(tmp_path / "in.mat"), input_key="u")
    np.testing.assert_allclose(got, want[:2], rtol=RTOL, atol=ATOL)
    # an HDF5 batch in native layout, read through the optional h5py
    import h5py

    with h5py.File(tmp_path / "in.h5", "w") as f:
        f["x"] = x[:2]
    got = predictor.predict_file(str(tmp_path / "in.h5"))
    np.testing.assert_allclose(got, want[:2], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="does not match"):
        predictor.predict_array(t_eval._prepare_inputs(predictor.problem, x[:, :64]))


def test_checkpoint_guards(burgers, tmp_path):
    cfg, path, _, _ = burgers
    restored = t_ckpt.restore(path)
    assert restored["config"] == "burgers"
    other = tmp_path / "other.pt"
    t_ckpt.save(str(other), restored["state_dict"], "sod")
    with pytest.raises(ValueError, match="holds benchmark 'sod'"):
        t_eval.Predictor(cfg, str(other), device="cpu")
    torch.save({"weights": 1}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        t_ckpt.restore(str(tmp_path / "bad.pt"))


def test_predictor_needs_cuda_or_explicit_cpu(burgers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, path, _, _ = burgers
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_eval.Predictor(cfg, path)


def test_health_and_info(server):
    base, _ = server
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["benchmark"] == "burgers"
    with urllib.request.urlopen(base + "/info", timeout=30) as r:
        info = json.loads(r.read())
    assert info["input_shape"] == [128, 1] and info["n_head"] == 2
    assert info["device"] == "cpu" and info["batch_size"] == 8


def test_post_npy_matches_predict_array(server, burgers, predictor):
    base, _ = server
    _, _, x, want = burgers
    for n in (1, 8, 13):
        code, body = _post(base + "/predict", _npy(x[:n]))
        assert code == 200, body
        got = np.load(io.BytesIO(body))
        np.testing.assert_allclose(got, predictor.predict_array({"x": x[:n]}), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, want[:n], rtol=RTOL, atol=ATOL)
    code, body = _post(base + "/predict", _npy(x[:2]), format="mat")
    assert code == 200
    from scipy.io import loadmat

    np.testing.assert_allclose(loadmat(io.BytesIO(body))["pred"], want[:2], rtol=RTOL, atol=ATOL)


def test_concurrent_requests(server, burgers):
    base, srv = server
    _, _, x, want = burgers
    calls_before = srv.batcher.n_calls
    results = {}

    def post(i):
        results[i] = _post(base + "/predict", _npy(x[i : i + 1]))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i in range(6):
        code, body = results[i]
        assert code == 200, body
        np.testing.assert_allclose(np.load(io.BytesIO(body)), want[i : i + 1], rtol=RTOL, atol=ATOL)
    assert 1 <= srv.batcher.n_calls - calls_before <= 6


@pytest.mark.parametrize(
    "body,params,needle",
    [
        (b"not an array", {}, "unrecognized input payload"),
        (b"\x89HDF\r\n\x1a\n" + b"\0" * 64, {}, "h5py"),
        (_npy(np.zeros((2, 64, 1), np.float32)), {}, "does not match"),
        (_npy(np.zeros((2, 128, 1), np.float32)), {"batch_size": 0}, "batch_size"),
        (_npy(np.zeros((2, 128, 1), np.float32)), {"format": "csv"}, "format"),
        (_npy(np.zeros((0, 128, 1), np.float32)), {}, "empty"),
    ],
)
def test_bad_payloads_are_400(server, body, params, needle):
    base, _ = server
    code, reply = _post(base + "/predict", body, **params)
    assert code == 400
    assert needle in json.loads(reply)["error"]


def test_server_answers_hdf5_bodies(burgers, server, tmp_path, monkeypatch):
    """An HDF5 body (a plain .h5 in native layout, or a MATLAB v7.3 .mat
    stored column-major) is answered as the JAX forward on the same
    samples; without h5py it is a 400 naming it."""
    from tests.test_torch_io import write_h5, write_v73

    _, _, x, want = burgers
    base, _ = server
    write_h5(tmp_path / "in.h5", {"x": x[:3]})
    write_v73(tmp_path / "in.mat", {"u": x[3:5, :, 0]})
    code, body = _post(base + "/predict", (tmp_path / "in.h5").read_bytes())
    assert code == 200, body
    np.testing.assert_allclose(np.load(io.BytesIO(body)), want[:3], rtol=RTOL, atol=ATOL)
    code, body = _post(base + "/predict", (tmp_path / "in.mat").read_bytes(), key="u")
    assert code == 200, body
    np.testing.assert_allclose(np.load(io.BytesIO(body)), want[3:5], rtol=RTOL, atol=ATOL)
    monkeypatch.setitem(sys.modules, "h5py", None)
    code, body = _post(base + "/predict", (tmp_path / "in.h5").read_bytes())
    assert code == 400
    assert "h5py" in json.loads(body)["error"]


def test_unknown_path_is_404(server):
    base, _ = server
    code, _ = _post(base + "/nope", b"")
    assert code == 404


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import position_induced_transformer_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'position_induced_transformer_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 20
    assert "position_induced_transformer_torch.kernels.posatt_tf_fixed" in names
