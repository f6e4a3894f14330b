"""Run a test's code in several ranks of a ``torch.distributed`` world on
the CPU: one Python process per rank, meeting under gloo at a
``FileStore`` in the test's own directory (so no port is fixed and
concurrent tests do not meet), for the port's data-parallel tests.

A child script is the preamble below (``rank``, ``world``, ``tmp`` and
``repo`` defined, the group initialized) followed by the test's body; the
group is destroyed when the body ends, and every process is reaped, killed
if it outlives the timeout, even when the test fails.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PREAMBLE = """\
import os, sys
rank, world, tmp, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank, world_size=world)
try:
{body}
finally:
    dist.destroy_process_group()
"""


def run_ranks(tmp_path, body: str, world: int = 2, timeout: float = 240.0, name: str = "child"):
    """Start ``world`` ranks of ``body`` (code indented as a module's; it
    writes its results under ``tmp``) in ``tmp_path/name``, wait for all,
    and raise with every failed rank's output."""
    tmp = os.path.join(str(tmp_path), name)
    os.makedirs(tmp)
    script = os.path.join(tmp, "child.py")
    with open(script, "w") as f:
        f.write(_PREAMBLE.format(body=textwrap.indent(textwrap.dedent(body), "    ")))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    try:
        for r in range(world):
            with open(logs[r], "wb") as log:  # a file: no rank blocks on a full pipe
                procs.append(subprocess.Popen(
                    [sys.executable, script, str(r), str(world), tmp, REPO],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r], errors="replace") as f:
                bad.append(f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
    if bad:
        raise AssertionError("\n".join(bad))
    return tmp
