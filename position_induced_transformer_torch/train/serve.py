"""HTTP model server: a warm checkpoint behind a small REST surface.

- ``GET  /health``  -> ``{"status": "ok", "benchmark": ..., "requests": N,
  "device_calls": M}``
- ``GET  /info``    -> benchmark, model variant, the checkpoint's SHA-256 and model
  configuration summary
- ``POST /predict`` -> the body is a ``.npy``, MATLAB ``.mat`` or HDF5
  input batch (raw values, the layout ``infer`` takes), sniffed from its
  magic bytes and read as ``infer`` reads the file: an HDF5 body is a
  plain ``.h5`` in native layout (MATLAB v7.3 files start with a v5-style
  header and go the ``.mat`` way); HDF5 needs the optional h5py. Query
  parameters: ``key`` (input variable, default ``x``), ``batch_size``,
  ``format`` (``npy`` or ``mat``), ``rollout_steps`` (the horizon of an
  autoregressive benchmark, default its configured one; at most
  ``PIT_SERVE_MAX_ROLLOUT``, default max(100, 4 x the configured one)).
  The reply is the predictions as ``.npy`` bytes, or a ``.mat`` with
  variable ``pred``.
  A benchmark on per-sample meshes (elasticity) takes a ``.mat`` holding
  ``x`` and ``mesh``; a bare ``.npy`` is answered with 400. elasticity_tf
  reads each cloud from its inputs' first two channels and takes a bare
  ``.npy``. darcy takes raw (n, s, s, 1) grids at the server's resolution
  (``setup_kwargs={"downsampling": ...}``), or flattened ones at the
  training resolution, normalized with the checkpoint's statistics.
  naca takes a ``.mat`` holding ``x``, ``mesh_in``, ``mesh_ltt`` and
  ``mesh_out``; vorticity a window of frames (n, s*s, memory) and answers
  its rollout (n, s*s, 1, steps).

Malformed requests are 400s; failures while running the model are 500s.
Device work runs on one worker thread with dynamic batching: concurrent
shape-compatible requests are concatenated into one call of the model.

With a ``mesh`` (``make_server(mesh=...)``, every rank of a
``torch.distributed`` world calling it alike) rank 0 binds the HTTP server.
Its worker broadcasts each call of the model (the request dict, the
horizon and the batch size) to the other ranks, whose servers follow those
broadcasts (:class:`FollowerServer`), and every rank runs its shard of
each device batch (a model axis's ranks the same rows, with the whole
weights; a stage axis every batch through the pipelined forward); rank
0's ``server_close`` stops them.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

# magic bytes -> temp-file suffix, routing the body through the loaders
# infer uses (load_mat for both .mat generations, native-layout h5py for
# plain HDF5; see evaluate._load_input)
_MAGIC = (
    (b"\x93NUMPY", ".npy"),
    (b"MATLAB", ".mat"),  # v5 and v7.3 .mat header text
    (b"\x89HDF\r\n\x1a\n", ".h5"),
)
_MAX_BODY_BYTES = 512 * 1024 * 1024


def _sniff_suffix(body: bytes) -> str:
    for magic, suffix in _MAGIC:
        if body.startswith(magic):
            return suffix
    raise ValueError(
        "unrecognized input payload: expected .npy bytes, a MATLAB .mat "
        "file, or an HDF5 file"
    )


class _Request:
    __slots__ = ("data", "steps", "batch_size", "done", "result", "error")

    def __init__(self, data, steps, batch_size):
        self.data = data
        self.steps = steps
        self.batch_size = batch_size
        self.done = threading.Event()
        self.result = None
        self.error = None

    def key(self):
        # coalescible iff same horizon, batch override and per-sample shapes
        return (
            self.steps,
            self.batch_size,
            tuple((k, tuple(np.shape(v)[1:])) for k, v in sorted(self.data.items())),
        )


class _Batcher:
    """Dynamic batching: the worker drains whatever is queued when it
    becomes free and runs shape-compatible requests as one concatenated
    call (no added delay when idle, full coalescing when busy)."""

    def __init__(self, predictor):
        self.predictor = predictor
        self._queue: list[_Request] = []
        self._cv = threading.Condition()
        self._closing = False
        self.n_calls = 0  # device batches run, written by the worker only
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the worker once the requests queued before are answered;
        under a mesh it then tells the other ranks to stop."""
        with self._cv:
            self._closing = True
            self._cv.notify()
        self._thread.join(60)

    def predict(self, data, steps, batch_size) -> np.ndarray:
        req = _Request(data, steps, batch_size)
        with self._cv:
            self._queue.append(req)
            self._cv.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _worker(self):
        if self.predictor.device.index is not None:  # a thread's current card is its own
            import torch

            torch.cuda.set_device(self.predictor.device)
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait()
                batch, self._queue = self._queue, []
                if not batch:  # closing, and every request answered
                    if self.predictor.mesh is not None:
                        _broadcast_call(self.predictor.mesh, None)
                    return
            try:
                self._run_batch(batch)
            except Exception as e:  # the one worker must not die and leave
                # every waiter blocked; each waiter gets the error, and the
                # worker goes on
                for r in batch:
                    if not r.done.is_set():
                        r.error = r.error or e
                        r.done.set()

    def _run_batch(self, batch):
        groups: dict = {}
        for r in batch:
            groups.setdefault(r.key(), []).append(r)
        for reqs in groups.values():
            try:
                sizes = [int(r.data["x"].shape[0]) for r in reqs]
                data = {
                    k: np.concatenate([np.asarray(r.data[k]) for r in reqs])
                    for k in reqs[0].data
                }
                call = (data, reqs[0].steps, reqs[0].batch_size)
                if self.predictor.mesh is not None:
                    _broadcast_call(self.predictor.mesh, call)
                out = self.predictor.predict_array(*call)
                bs = self.predictor._batch_size(reqs[0].batch_size)
                self.n_calls += -(-sum(sizes) // bs)
                start = 0
                for r, n in zip(reqs, sizes):
                    r.result = out[start : start + n]
                    start += n
            except Exception as e:  # delivered to every waiter of the group
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.done.set()


def _broadcast_call(mesh, call):
    """Rank 0 sends one call of ``Predictor.predict_array`` (its
    arguments; None to stop) to every rank; the others receive it."""
    import torch.distributed as dist

    if mesh.group is None:  # a world of one
        return call
    box = [call]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


class FollowerServer:
    """The server of a rank other than 0 under a mesh: ``serve_forever``
    runs every model call rank 0's worker broadcasts, on this rank's shard
    of each device batch, until rank 0's server closes."""

    def __init__(self, predictor):
        self.predictor = predictor

    def serve_forever(self):
        mesh = self.predictor.mesh
        while True:
            call = _broadcast_call(mesh, None)
            if call is None:
                return
            try:
                self.predictor.predict_array(*call)
            except Exception:  # rank 0 answers the request with its own error
                traceback.print_exc()

    def server_close(self):
        pass


class PredictHandler(BaseHTTPRequestHandler):
    server: "PredictServer"

    def log_message(self, fmt, *args):
        if self.server.verbose:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: dict):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        path = urlparse(self.path).path
        srv = self.server
        if path == "/health":
            self._reply_json(200, {
                "status": "ok",
                "benchmark": srv.predictor.cfg.name,
                "requests": srv.n_requests,
                "device_calls": srv.batcher.n_calls,
            })
        elif path == "/info":
            cfg = srv.predictor.cfg
            m = cfg.model
            self._reply_json(200, {
                "benchmark": cfg.name,
                "model_variant": cfg.model_variant or "pit",
                "checkpoint_sha256": srv.predictor.checkpoint_sha256,
                "device": str(srv.predictor.device),
                "hid_dim": m.hid_dim,
                "n_head": m.n_head,
                "n_blocks": m.n_blocks,
                "in_dim": m.in_dim,
                "out_dim": m.out_dim,
                "rollout_steps": cfg.rollout_steps,
                "batch_size": srv.predictor._batch_size(),
                "input_shape": [
                    int(s) for s in np.shape(srv.predictor.problem.test_data["x"])[1:]
                ],
            })
        else:
            self._reply_json(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        parsed = urlparse(self.path)
        if parsed.path != "/predict":
            self._reply_json(404, {"error": f"unknown path {parsed.path!r}"})
            return
        srv = self.server
        try:  # request parsing and validation: failures are 400s
            length = int(self.headers.get("Content-Length", 0))
            if length > _MAX_BODY_BYTES:
                self._reply_json(413, {
                    "error": f"payload {length} bytes exceeds the "
                    f"{_MAX_BODY_BYTES}-byte limit"
                })
                return
            body = self.rfile.read(length)
            q = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
            key = q.get("key", "x")
            steps = int(q.get("rollout_steps", srv.predictor.cfg.rollout_steps))
            if not 0 <= steps <= srv.max_rollout_steps:
                raise ValueError(
                    f"rollout_steps must be in [0, {srv.max_rollout_steps}] "
                    f"(PIT_SERVE_MAX_ROLLOUT), got {steps}"
                )
            bs = int(q["batch_size"]) if "batch_size" in q else None
            if bs is not None and bs < 1:
                raise ValueError(f"batch_size must be >= 1, got {bs}")
            out_fmt = q.get("format", "npy")
            if out_fmt not in ("npy", "mat"):
                raise ValueError(f"unknown output format {out_fmt!r}")
            suffix = _sniff_suffix(body)
            with tempfile.NamedTemporaryFile(suffix=suffix) as f:
                f.write(body)
                f.flush()
                data = srv.predictor.prepare_file(f.name, key)
        except Exception as e:  # every parse failure is the client's
            if srv.verbose:
                traceback.print_exc()
            self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
            return
        try:  # model execution: failures are 500s
            pred = srv.batcher.predict(data, steps, bs)
            with srv.lock:
                srv.n_requests += 1
        except Exception as e:
            if srv.verbose:
                traceback.print_exc()
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        buf = io.BytesIO()
        if out_fmt == "mat":
            from scipy.io import savemat

            savemat(buf, {"pred": pred})
        else:
            np.save(buf, pred)
        self._reply(200, buf.getvalue(), "application/octet-stream")


class PredictServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the warm Predictor and its batcher."""

    daemon_threads = True

    def __init__(self, addr, predictor, verbose: bool = True):
        super().__init__(addr, PredictHandler)
        self.predictor = predictor
        self.lock = threading.Lock()  # guards n_requests
        self.batcher = _Batcher(predictor)
        self.n_requests = 0
        self.verbose = verbose
        self.max_rollout_steps = int(os.environ.get(
            "PIT_SERVE_MAX_ROLLOUT", str(max(100, 4 * predictor.cfg.rollout_steps))))

    def server_close(self):
        super().server_close()
        self.batcher.close()


def make_server(
    config,
    checkpoint_path: str,
    host: str = "127.0.0.1",
    port: int = 8765,
    warmup: bool = True,
    verbose: bool = True,
    data_path: Optional[str] = None,
    setup_kwargs: Optional[dict] = None,
    device="cuda",
    model_variant: Optional[str] = None,
    mesh=None,
):
    """Build the server, bound but not yet serving (call ``serve_forever``).
    ``setup_kwargs``: extra arguments of the benchmark's setup (darcy
    answering at 421^2: ``{"downsampling": 1}``); ``model_variant``: the TF
    family's ablation model the checkpoint holds. ``mesh``: every rank
    calls ``make_server`` alike; rank 0 gets the bound
    :class:`PredictServer`, every other rank a :class:`FollowerServer`.

    ``warmup=True`` runs one batch at the serving batch size first, so the
    first request does not pay for kernel builds and allocator growth. The
    batch carries what a request carries: ``x`` and the variables the
    benchmark's per-sample geometry requires, without optional extras.
    """
    from position_induced_transformer_torch.train.evaluate import Predictor

    from position_induced_transformer_torch.parallel import multihost

    predictor = Predictor(config, checkpoint_path, data_path=data_path, setup_kwargs=setup_kwargs,
                          device=device, model_variant=model_variant, mesh=mesh)
    if warmup:  # every rank alike
        keys = {"x"} | set(predictor.required_keys)
        data = {k: np.asarray(v) for k, v in predictor.problem.test_data.items() if k in keys}
        idx = np.minimum(np.arange(predictor._batch_size()), data["x"].shape[0] - 1)
        predictor.predict_array({k: v[idx] for k, v in data.items()}, predictor.cfg.rollout_steps)
    if predictor.mesh is not None and not multihost.is_main():
        return FollowerServer(predictor)
    return PredictServer((host, port), predictor, verbose=verbose)


def serve(config, checkpoint_path: str, **kwargs) -> None:
    """Blocking entry point: build the server and serve until interrupted."""
    server = make_server(config, checkpoint_path, **kwargs)
    if isinstance(server, PredictServer):
        host, port = server.server_address[:2]
        print(
            f"serving benchmark {server.predictor.cfg.name!r} on "
            f"http://{host}:{port} (POST /predict, GET /health, GET /info)",
            flush=True,
        )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
