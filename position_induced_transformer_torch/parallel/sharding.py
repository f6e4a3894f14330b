"""Device meshes on ``torch.distributed``: one process per rank.

The JAX package drives every device from one process and lets GSPMD place
the collectives over a ``jax.sharding.Mesh``. Here each rank is its own
process (torchrun, or the command line's ``--multihost``), and a
:class:`DataMesh` stands for the mesh: ``mesh="data=N,model=M"`` means an
initialized default process group of world size N x M of which this
process is one rank. Every rank runs the hand-written kernels on its part
of the work; the collectives are explicit.

- **Rank order**: a ``dcn=K,data=N,model=M`` mesh is the JAX package's
  ``devices.reshape(K, N, M)``: rank ``((s N) + d) M + m`` is slice ``s``,
  data index ``d``, model index ``m`` (the model index varies fastest).
- **Data parallel**: a batch of B splits over the ``K N`` batch indices
  ``b = s N + d`` (rows ``[b B / KN, (b + 1) B / KN)``, :func:`shard_batch`),
  as the JAX package's ``batch_spec`` shards the leading axis over
  ``('dcn', 'data')``; ranks that differ only in their model index take the
  same rows. Gradients are summed over this rank's data group, then over
  its dcn group (the ranks of its model index in the other slices).
- **Tensor parallel** (``model=M``, training only, either family):
  :mod:`.tensor_parallel` splits each MLP column- then row-parallel over
  the model group, and ``PiT``'s heads where M divides them (the TF
  family's attention stays whole); prediction, evaluation and serving
  replicate the whole weights, as in JAX.
- **Sequence parallel** (ZSSR decode): the decoder's query rows split over
  the data group (:func:`sequence_shard_geometry`,
  :func:`sequence_shard_tf_geometry`); each rank decodes its slab against
  the whole latent cloud and :func:`sequence_gather` joins the slabs.
- **Pipeline** (``stage=K``, which combines with no other axis): a
  :class:`StageMesh` (:mod:`.pipeline`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dcn", "data", "model", "stage")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``dcn`` slices of ``data`` x ``model`` ranks each (world = dcn x
    data x model, rank ``((s data) + d) model + m``), and this process's
    ``rank`` in it. ``data_group`` holds the ranks of this rank's slice and
    model index, ``dcn_group`` those of its data and model index in every
    slice (None with one slice), ``model_group`` those of its slice and
    data index (None without a model axis), ``batch_group`` every rank of
    its model index in batch order; ``group`` is the whole world. Groups
    are None where no process group is initialized (a world of one)."""

    dcn: int
    data: int
    model: int = 1
    rank: int = 0
    group: Optional[object] = None
    data_group: Optional[object] = None
    dcn_group: Optional[object] = None
    model_group: Optional[object] = None
    batch_group: Optional[object] = None

    @property
    def n_batch(self) -> int:
        """Batch-sharding ways: the dcn axis times the data axis."""
        return self.dcn * self.data

    @property
    def batch_rank(self) -> int:
        """This rank's batch index ``s data + d``: its shard of a batch."""
        return self.rank // self.model

    @property
    def data_rank(self) -> int:
        """This rank's place in its slice: its slab of a sequence split,
        the same on every rank of its model group."""
        return self.batch_rank % self.data

    @property
    def model_rank(self) -> int:
        """This rank's model index: its part of a tensor-parallel layer."""
        return self.rank % self.model


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """The pipeline's 1-D mesh of ``stage`` ranks (the whole world; rank s
    holds stage s), made by :func:`.pipeline.make_stage_mesh`. ``group`` is
    None in a world of one."""

    stage: int
    rank: int = 0
    group: Optional[object] = None

    n_batch = 1  # the batch stays whole on every stage


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _need(spec: str, want: int, world: int) -> None:
    if want != world:
        raise ValueError(
            f"mesh {spec} needs {want} devices but only {world} are visible "
            "(the world size of the default process group)"
        )


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_dcn: int = 1) -> DataMesh:
    """The :class:`DataMesh` of ``n_dcn`` slices of ``n_data`` x
    ``n_model`` ranks over the default process group (``n_data`` defaults
    to the world over ``n_model`` x ``n_dcn``). The world must hold exactly
    ``n_dcn x n_data x n_model`` ranks. Every rank creates every group, in
    one order, as ``torch.distributed.new_group`` requires."""
    world = _world()
    if n_data is None:
        n_data = max(1, world // (n_model * n_dcn))
    K, N, M = n_dcn, n_data, n_model
    _need(f"dcn={K},data={N},model={M}", K * N * M, world)
    if not dist.is_initialized():
        return DataMesh(dcn=K, data=N, model=M)
    rank = dist.get_rank()
    world_group = dist.group.WORLD
    if K == 1 and M == 1:
        return DataMesh(K, N, M, rank, world_group, world_group, batch_group=world_group)
    at = lambda s, d, m: (s * N + d) * M + m
    s0, d0, m0 = rank // (N * M), (rank // M) % N, rank % M
    mine = {}
    for s in range(K):
        for m in range(M):
            g = dist.new_group([at(s, d, m) for d in range(N)])
            if (s, m) == (s0, m0):
                mine["data_group"] = g
    if K > 1:
        for d in range(N):
            for m in range(M):
                g = dist.new_group([at(s, d, m) for s in range(K)])
                if (d, m) == (d0, m0):
                    mine["dcn_group"] = g
    if M > 1:
        for s in range(K):
            for d in range(N):
                g = dist.new_group([at(s, d, m) for m in range(M)])
                if (s, d) == (s0, d0):
                    mine["model_group"] = g
        for m in range(M):
            g = dist.new_group([at(s, d, m) for s in range(K) for d in range(N)])
            if m == m0:
                mine["batch_group"] = g
    else:
        mine["batch_group"] = world_group
    return DataMesh(K, N, M, rank, world_group, **mine)


def parse_mesh_spec(spec):
    """Resolve the runner's and command line's ``mesh`` argument.

    A :class:`DataMesh` or :class:`StageMesh` is returned as it is;
    ``None``, ``''``, ``'none'`` and ``'1'`` give None (one process, no
    mesh). ``'auto'``: the whole world as the data axis, or, where torchrun
    says the world spans several hosts (``LOCAL_WORLD_SIZE`` dividing it),
    one slice per host; None when no process group is initialized or the
    world is one. ``'data=N[,model=M]'``, optionally with ``dcn=K``: N x M
    x K must equal the world size. ``'stage=K'``: the GPipe pipeline over
    K ranks (:func:`.pipeline.make_stage_mesh`), combined with no other
    axis. The specs accepted and refused, and the errors, are the JAX
    package's (``parallel/sharding.py`` ``parse_mesh_spec``), except that a
    spec naming fewer devices than the world is refused (a rank cannot sit
    out)."""
    if spec is None or isinstance(spec, (DataMesh, StageMesh)):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "none", "1"):
        return None
    if s == "auto":
        world = _world()
        if world <= 1:
            return None
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if 0 < local < world and world % local == 0:
            return make_mesh(n_data=local, n_dcn=world // local)
        return make_mesh(n_data=world)
    sizes = {"data": 1, "model": 1, "stage": 0, "dcn": 1}
    seen = set()
    for part in s.split(","):
        key, sep, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not val.isdigit() or int(val) < 1:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'auto', "
                "'data=N[,model=M]', 'dcn=K,data=N[,model=M]' or "
                "'stage=K' with positive integers"
            )
        if key in seen:
            raise ValueError(f"duplicate mesh axis {key!r} in {spec!r}")
        seen.add(key)
        if key not in AXES:
            raise ValueError(
                f"unknown mesh axis {key!r} in {spec!r} (axes: dcn, data, model, stage)"
            )
        sizes[key] = int(val)
    world = _world()
    if sizes["stage"]:
        if sizes["data"] > 1 or sizes["model"] > 1 or sizes["dcn"] > 1:
            raise ValueError(
                f"mesh {spec!r}: the 'stage' (pipeline) axis cannot be "
                "combined with 'dcn'/'data'/'model' — the GPipe schedule "
                "owns its whole mesh"
            )
        from position_induced_transformer_torch.parallel.pipeline import make_stage_mesh

        _need(repr(spec), sizes["stage"], world)
        return make_stage_mesh(sizes["stage"])
    _need(repr(spec), sizes["dcn"] * sizes["data"] * sizes["model"], world)
    return make_mesh(n_data=sizes["data"], n_model=sizes["model"], n_dcn=sizes["dcn"])


def data_axis_size(mesh) -> int:
    """Total batch-sharding ways: the data axis times the dcn axis (1 for
    no mesh and for a stage mesh)."""
    return 1 if mesh is None else mesh.n_batch


def _rows(n: int, k: int, i: int) -> slice:
    if n % k:
        raise ValueError(f"{n} rows are not divisible over {k} ranks")
    return slice(i * n // k, (i + 1) * n // k)


def shard_rows(mesh: DataMesh, a):
    """This rank's rows of ``a``: batch index b of n takes ``[b B / n,
    (b + 1) B / n)`` of the leading axis (a view); the ranks of one model
    group take the same rows."""
    return a[_rows(a.shape[0], mesh.n_batch, mesh.batch_rank)]


def shard_batch(mesh: DataMesh, batch: dict) -> dict:
    """This rank's rows (:func:`shard_rows`) of every variable of a batch
    dict."""
    return {k: shard_rows(mesh, v) for k, v in batch.items()}


def gather_rows(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """Every batch index's rows of ``t`` (this rank's :func:`shard_rows`
    result), joined in batch order over this rank's batch group."""
    return all_gather(mesh.batch_group, t)


def all_reduce(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over the data group, then over the dcn group: the
    two-level gradient all-reduce (within a slice first, then one hop
    across slices), among the ranks of this rank's model index. Nothing to
    do without a process group."""
    if mesh.group is None:
        return t
    dist.all_reduce(t, group=mesh.data_group)
    if mesh.dcn_group is not None:
        dist.all_reduce(t, group=mesh.dcn_group)
    return t


def all_reduce_grads(mesh: DataMesh, params, loss: torch.Tensor, batch_mean: bool = False):
    """The gradient step's collective: every gradient of ``params`` (those
    that have one) and the shard's ``loss``, flattened into one buffer and
    summed by :func:`all_reduce`, then written back; returns the global
    loss. A batch-summed loss sums; a ``batch_mean`` loss (the mean over
    this rank's equal shard) averages, so the gradients are the global
    loss's either way. One rank leaves every value as it was."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1).float()])
    all_reduce(mesh, flat)
    if batch_mean:
        flat /= mesh.n_batch
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()
    return flat[-1]


def all_gather(group, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), concatenated along
    ``dim`` in rank order. Gloo documents ``all_gather`` for CPU tensors
    only, so a CUDA tensor of a gloo group goes through host memory."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    host = src.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def replicate_tree(mesh: Optional[DataMesh], tree: dict) -> dict:
    """Broadcast every tensor of the dict ``tree`` from rank 0 over the
    world, in place; returns ``tree``. A model's ``state_dict()`` shares
    its parameters' storage, so this replicates the model."""
    if mesh is not None and mesh.group is not None:
        for t in tree.values():
            dist.broadcast(t, src=0, group=mesh.group)
    return tree


def _pad_rows(a: Optional[torch.Tensor], size: int, pad: bool) -> Optional[torch.Tensor]:
    """``a`` with its leading axis padded to a multiple of ``size`` by
    repeating its last row (``pad``), or as it is where ``size`` divides it."""
    if a is None or a.shape[0] % size == 0:
        return a
    if not pad:
        raise ValueError(
            f"{a.shape[0]} decoder rows are not divisible over the data axis "
            f"({size}); pass pad=True"
        )
    reps = a[-1:].expand(size - a.shape[0] % size, *a.shape[1:])
    return torch.cat([a, reps], dim=0)


def _slab(mesh: DataMesh, a: Optional[torch.Tensor], pad: bool) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = _pad_rows(a, mesh.data, pad)
    return a[_rows(a.shape[0], mesh.data, mesh.data_rank)].contiguous()


def sequence_shard_geometry(mesh: DataMesh, geom, pad: bool = False):
    """Sequence parallelism for ZSSR-scale decode: this rank's slab of the
    decoder's query rows. For the torch family's
    :class:`~..models.geometry.Geometry`, ``dist_up`` and ``thr_up`` are
    split over the data axis; everything else stays whole. ``pad=True``
    first pads the row axis to a multiple of the axis size by repeating the
    last row (the 421^2 = 177,241-row Darcy decode); the model then decodes
    the padded rows too, and :func:`sequence_gather` trims them off. A
    TF-family ``TFGeometry`` goes to :func:`sequence_shard_tf_geometry`;
    a lazy geometry (no ``dist_up``) raises."""
    if hasattr(geom, "m_cross"):
        raise ValueError(
            "sequence_shard_geometry handles torch-family Geometry; for a "
            "TFGeometry use sequence_shard_tf_geometry (its m_cross is also "
            "read transposed by the encoder, whose columns stay whole)"
        )
    if geom.dist_up is None:
        raise ValueError(
            "sequence_shard_geometry needs a materialized decoder "
            "distance matrix (geom.dist_up); this geometry is lazy "
            "(raw per-sample coordinates) — returning it unchanged "
            "would silently decode ALL rows on every device"
        )
    return dataclasses.replace(
        geom, dist_up=_slab(mesh, geom.dist_up, pad), thr_up=_slab(mesh, geom.thr_up, pad)
    )


def sequence_shard_tf_geometry(mesh: DataMesh, geom):
    """The TF family's counterpart of :func:`sequence_shard_geometry` (the
    JAX package's ``sequence_constrain_tf_geometry``): this rank's slab of
    the decoder's rows of ``m_cross`` and ``thr_up``, padded as there with
    ``pad=True``. The encoder reads ``m_cross`` transposed, whole:
    ``m_cross_t`` keeps it. A geometry with ``m_qry`` (a decoder
    self-attention, which reads every query row) raises."""
    if geom.m_qry is not None:
        raise ValueError(
            "sequence-parallel decode needs a decoder without self-attention: "
            "its self-attention over m_qry reads every query row"
        )
    return geom._replace(
        m_cross=_slab(mesh, geom.m_cross, True), thr_up=_slab(mesh, geom.thr_up, True),
        m_cross_t=geom.cross_t(),
    )


def sequence_gather(mesh: DataMesh, out: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The decoder output (B, rows, C) of every rank's slab, joined over
    the data group in slab order and trimmed to the first ``n_rows`` rows
    (the padding off)."""
    return all_gather(mesh.data_group, out, dim=1)[:, :n_rows]
