"""Joining a multi-process ``torch.distributed`` world: one process per
rank.

Every process runs the same command with the same configuration, seed and
data (the synthetic generators are seed-deterministic; real datasets must
be readable from every host). Epoch shuffles come from the configuration's
seed, so every rank computes the same permutations without communication.
Only rank 0 writes logs, checkpoints, predictions and plots
(:func:`is_main`). The port starts no processes: torchrun does, or one
command per rank with ``--multihost coordinator=...``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _parse(spec: str) -> dict:
    kw: dict = {}
    for part in str(spec).split(","):
        key, sep, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or key not in ("coordinator", "num_processes", "process_id"):
            raise ValueError(
                f"bad --multihost component {part!r}; expected "
                "'auto' or 'coordinator=HOST:PORT,num_processes=N,"
                "process_id=I'"
            )
        kw[key] = val if key == "coordinator" else int(val)
    missing = {"coordinator", "num_processes", "process_id"} - set(kw)
    if missing:
        raise ValueError(f"--multihost spec is missing {sorted(missing)} (got {spec!r})")
    return kw


def initialize(spec: Optional[str] = "auto", device="cuda") -> None:
    """Join the default process group.

    ``spec``:
      - ``'auto'``: torchrun's environment (``RANK``, ``WORLD_SIZE``,
        ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card);
      - ``'coordinator=HOST:PORT,num_processes=N,process_id=I'``: rank I of
        N, meeting at ``tcp://HOST:PORT`` (rank 0 listens there).

    The backend is NCCL when ``device`` is CUDA and gloo on the CPU. On
    CUDA the process's current device becomes ``cuda:LOCAL_RANK`` where
    torchrun set it. Call it before anything touches the device; the
    command line does so first thing."""
    if spec is None or spec == "auto":
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"--multihost auto reads torchrun's environment; missing {missing}"
            )
        kw = dict(init_method="env://")
    else:
        p = _parse(spec)
        kw = dict(init_method=f"tcp://{p['coordinator']}", world_size=p["num_processes"],
                  rank=p["process_id"])
    cuda = torch.device(device).type == "cuda"
    if cuda and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend="nccl" if cuda else "gloo", **kw)


def is_main() -> bool:
    """True on the process that writes logs and artifacts: rank 0, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (after rank 0's checkpoint write); nothing to
    wait for in one process."""
    if dist.is_initialized():
        dist.barrier()
