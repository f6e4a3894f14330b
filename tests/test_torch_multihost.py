"""The port's multi-process entry (``parallel.multihost``, the command
line's ``--multihost`` and ``--mesh``) and its data-parallel server on the
CPU under gloo, against the single-process port: two ``train`` processes
joined by ``--multihost coordinator=...`` whose rank-0 checkpoint restores
in one process (the JAX package's tests/test_parallel.py:775); ``evaluate``
and ``infer`` from the command line with ``--mesh data=2``; the spec
errors (:872); and ``make_server(mesh="data=2")``, whose replies equal the
single-process server's and ``infer(mesh="data=2")``'s.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from position_induced_transformer_torch import cli as t_cli
from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.parallel import multihost
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from tests.torch_ranks import REPO, run_ranks

SET = ["--set", "grid=64", "--set", "latent_grid=16", "--set", "model.hid_dim=16",
       "--set", "model.n_blocks=2"]
CFG = t_configs.apply_overrides(t_configs.BURGERS, ["grid=64", "latent_grid=16",
                                                    "model.hid_dim=16", "model.n_blocks=2"])


def test_multihost_spec_errors(monkeypatch):
    """JAX's two errors (a bad component, a missing one), and ``auto``
    outside torchrun's environment; nothing is initialized."""
    with pytest.raises(ValueError, match="bad --multihost"):
        multihost.initialize("coordinator=localhost:1,nproc=2", device="cpu")
    with pytest.raises(ValueError, match="missing"):
        multihost.initialize("coordinator=localhost:1,num_processes=2", device="cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="missing"):
        multihost.initialize("auto", device="cpu")
    assert multihost.is_main()


@pytest.mark.parametrize("launch", ["coordinator", "torchrun_env", "model=2", "stage=2"])
def test_cli_two_process_train_restores_in_one_process(tmp_path, launch):
    """``train --multihost coordinator=localhost:P,... --mesh data=2`` in two
    processes (or ``--mesh model=2``: tensor parallel, ``--mesh stage=2``:
    the GPipe pipeline), or ``--multihost auto --mesh auto`` in the
    environment torchrun gives its ranks: the final row rank 0 prints, and the
    checkpoint and log it alone writes, equal a single-process run's
    (losses rtol 1e-4, weights rtol 2e-4 / atol 2e-5); the checkpoint (the
    model's own keys) evaluates in one process as the single-process one
    does (rtol 1e-5)."""
    s = socket.socket()
    s.bind(("localhost", 0))  # a free port for rank 0 to listen at
    port = s.getsockname()[1]
    s.close()
    ck, log = str(tmp_path / "dp.pt"), str(tmp_path / "dp.jsonl")
    argv = ["train", "--benchmark", "burgers", "--device", "cpu", "--epochs", "2", "--ntrain",
            "16", "--ntest", "8", "--seed", "0", "--checkpoint", ck, "--log", log, *SET]
    procs = []
    try:
        for r in range(2):
            env = dict(os.environ, OMP_NUM_THREADS="1")
            if launch != "torchrun_env":
                spec = f"coordinator=localhost:{port},num_processes=2,process_id={r}"
                mesh = "data=2" if launch == "coordinator" else launch
                flags = ["--multihost", spec, "--mesh", mesh]
            else:
                env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
                flags = ["--multihost", "auto", "--mesh", "auto"]
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "position_induced_transformer_torch", *argv, *flags],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    assert outs[1][0].decode().strip() == ""  # rank 1 prints nothing
    final = json.loads(outs[0][0].decode().strip().splitlines()[-1])["final"]
    with open(log) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]

    single = str(tmp_path / "single.pt")
    _, state, hist = t_runner.train(CFG, epochs=2, ntrain=16, ntest=8, seed=0, verbose=False,
                                    device="cpu", checkpoint_path=single)
    for k in ("train_loss", "rel_l2"):
        np.testing.assert_allclose(final[k], hist[-1][k], rtol=1e-4)
    restored = t_ckpt.restore(ck)
    assert set(restored["state_dict"]) == set(state.model.state_dict())
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(restored["state_dict"][k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    got = t_eval.evaluate(CFG, ck, ntest=8, device="cpu")
    want = t_eval.evaluate(CFG, single, ntest=8, device="cpu")
    np.testing.assert_allclose(got["rel_l2"], want["rel_l2"], rtol=1e-5)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("burgers")
    path = t_ckpt.save(str(d / "b.pt"), t_bench._make_model(CFG, torch.Generator().manual_seed(3))
                       .state_dict(), "burgers")
    x = t_bench.setup(CFG, ntrain=8, ntest=13, device="cpu").test_data["x"]
    np.save(d / "x.npy", x)
    return d, path, x


def test_cli_evaluate_and_infer_with_a_mesh(tmp_path, checkpoint):
    """``evaluate`` and ``infer`` from the command line with ``--mesh
    data=2`` in two ranks: rank 0 alone prints and writes, and what it
    prints and writes equals one process's output."""
    d, path, _ = checkpoint
    tmp = run_ranks(tmp_path, f"""
        import contextlib, io, json
        from position_induced_transformer_torch import cli
        out = {{}}
        for cmd, extra in (("evaluate", ["--ntest", "13"]),
                           ("infer", ["--input", {str(d / "x.npy")!r},
                                      "--output", os.path.join(tmp, f"p{{rank}}.npy")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main([cmd, "--benchmark", "burgers", "--device", "cpu", "--checkpoint",
                          {path!r}, "--mesh", "data=2", *{SET!r}, *extra])
            out[cmd] = buf.getvalue()
        with open(os.path.join(tmp, f"rank{{rank}}.json"), "w") as f:
            json.dump(out, f)
    """)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    assert ranks[1] == {"evaluate": "", "infer": ""}
    assert not os.path.exists(os.path.join(tmp, "p1.npy"))
    ev = json.loads(ranks[0]["evaluate"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_cli.main(["evaluate", "--benchmark", "burgers", "--device", "cpu", "--checkpoint", path,
                    "--ntest", "13", *SET])
        t_cli.main(["infer", "--benchmark", "burgers", "--device", "cpu", "--checkpoint", path,
                    "--input", str(d / "x.npy"), "--output", str(tmp_path / "p.npy"), *SET])
    want = json.loads(buf.getvalue().splitlines()[0])
    for k in ("rel_l1", "rel_l2", "rel_max", "rel_l1_quartiles"):
        np.testing.assert_allclose(ev[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.load(os.path.join(tmp, "p0.npy")), np.load(tmp_path / "p.npy"),
                               rtol=1e-5, atol=1e-6)


def test_make_server_with_a_mesh_matches_single_process(tmp_path, checkpoint):
    """``make_server(mesh="data=2")`` in two ranks: rank 0 binds and answers
    three concurrent requests (1, 8 and 13 samples: one to two device
    batches of 8, each shared out over the ranks), rank 1 follows its
    broadcasts until rank 0's server closes; every reply equals the
    single-process server's (rtol 1e-5 / atol 1e-6) and
    ``infer(mesh="data=2")``'s on the same samples to the bit."""
    d, path, x = checkpoint
    tmp = run_ranks(tmp_path, f"""
        import io, json, threading, urllib.request
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.train import evaluate
        from position_induced_transformer_torch.train.serve import make_server
        cfg = configs.apply_overrides(configs.BURGERS, {["grid=64", "latent_grid=16",
                                                        "model.hid_dim=16", "model.n_blocks=2"]!r})
        x = np.load({str(d / "x.npy")!r})
        sizes = ((0, 1), (0, 8), (0, 13))
        srv = make_server(cfg, {path!r}, port=0, verbose=False, device="cpu", mesh="data=2")
        replies = {{}}
        if rank == 0:
            t = threading.Thread(target=srv.serve_forever, daemon=True)
            t.start()
            url = "http://127.0.0.1:%d" % srv.server_address[1]

            def post(i, j):
                buf = io.BytesIO()
                np.save(buf, x[i:j])
                req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    replies[j] = np.load(io.BytesIO(r.read()))

            posts = [threading.Thread(target=post, args=s) for s in sizes]
            for p in posts:
                p.start()
            for p in posts:
                p.join(timeout=120)
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
            srv.shutdown()
            srv.server_close()
            np.savez(os.path.join(tmp, "served.npz"), **{{str(k): v for k, v in replies.items()}})
            with open(os.path.join(tmp, "health.json"), "w") as f:
                json.dump(health, f)
        else:
            srv.serve_forever()  # until rank 0 closes
        for i, j in sizes:
            np.save(os.path.join(tmp, f"in{{j}}.npy"), x[i:j])
            evaluate.infer(cfg, {path!r}, os.path.join(tmp, f"in{{j}}.npy"),
                           output_path=os.path.join(tmp, f"infer{{j}}.npy"), device="cpu",
                           mesh="data=2")
    """)
    served = np.load(os.path.join(tmp, "served.npz"))
    assert sorted(served.files, key=int) == ["1", "8", "13"]
    with open(os.path.join(tmp, "health.json")) as f:
        health = json.load(f)
    assert health["requests"] == 3 and 2 <= health["device_calls"] <= 4
    srv = make_server(CFG, path, port=0, verbose=False, device="cpu")
    try:
        for j in (1, 8, 13):
            got = served[str(j)]
            assert got.shape == (j, 64, 1)
            np.testing.assert_array_equal(got, np.load(os.path.join(tmp, f"infer{j}.npy")))
            want = srv.predictor.predict_array({"x": x[:j]})
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    finally:
        srv.server_close()
