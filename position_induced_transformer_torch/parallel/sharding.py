"""The data axis on ``torch.distributed``: one process per rank.

The JAX package drives every device from one process and lets GSPMD place
the collectives over a ``jax.sharding.Mesh``. Here each rank is its own
process (torchrun, or the command line's ``--multihost``), and a
:class:`DataMesh` stands for the mesh: ``mesh="data=N"`` means an
initialized default process group of world size N of which this process is
one rank. Parameters are replicated; every rank runs the hand-written
kernels on its shard of the batch; gradients are summed by an explicit
``all_reduce`` over the ranks' process groups.

- **Data parallel**: rank r takes rows ``[r B / n, (r + 1) B / n)`` of a
  batch of B (:func:`shard_batch`), as the JAX package's ``batch_spec``
  shards the leading axis over ``('dcn', 'data')``.
- **Multi-slice** (``dcn=K,data=N``): ranks ``[s N, (s + 1) N)`` form slice
  ``s``'s data group and ranks ``{s N + j}`` form dcn group ``j``, the
  order ``mesh_utils.create_hybrid_device_mesh`` gives; the gradient sum
  runs over the data group, then over the dcn group.
- **Sequence parallel** (ZSSR decode): the decoder's query rows split over
  the data group (:func:`sequence_shard_geometry`,
  :func:`sequence_shard_tf_geometry`); each rank decodes its slab against
  the whole latent cloud and :func:`sequence_gather` joins the slabs.

The model (head) axis and the pipeline (stage) axis are not ported yet:
``model=M`` (M > 1) and ``stage=K`` raise ``NotImplementedError``.
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
    """``dcn`` slices of ``data`` ranks each (world = dcn x data), and this
    process's ``rank`` in it. ``data_group`` holds the ranks of this rank's
    slice and ``dcn_group`` the ranks at its place in every slice (None
    without a second axis); ``group`` is the whole world. Groups are None
    where no process group is initialized (a world of one)."""

    dcn: int
    data: int
    rank: int = 0
    group: Optional[object] = None
    data_group: Optional[object] = None
    dcn_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.dcn * self.data

    @property
    def data_rank(self) -> int:
        """This rank's place in its slice: its slab of a sequence split."""
        return self.rank % self.data


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_dcn: int = 1) -> DataMesh:
    """The :class:`DataMesh` of ``n_dcn`` slices of ``n_data`` ranks over
    the default process group (``n_data`` defaults to the world over
    ``n_dcn``). The world must hold exactly ``n_dcn x n_data`` ranks. With
    ``n_dcn > 1`` every rank creates every slice's and every dcn group, in
    one order, as ``torch.distributed.new_group`` requires."""
    if n_model > 1:
        raise NotImplementedError(
            f"mesh model={n_model}: the model (head) axis is not ported yet"
        )
    world = _world()
    if n_data is None:
        n_data = max(1, world // n_dcn)
    want = n_dcn * n_data
    if want != world:
        raise ValueError(
            f"mesh dcn={n_dcn},data={n_data} needs {want} devices but only "
            f"{world} are visible (the world size of the default process group)"
        )
    if not dist.is_initialized():
        return DataMesh(dcn=n_dcn, data=n_data)
    rank = dist.get_rank()
    world_group = dist.group.WORLD
    if n_dcn == 1:
        return DataMesh(n_dcn, n_data, rank, world_group, world_group)
    data_group = dcn_group = None
    for s in range(n_dcn):
        g = dist.new_group(list(range(s * n_data, (s + 1) * n_data)))
        if rank // n_data == s:
            data_group = g
    for j in range(n_data):
        g = dist.new_group([s * n_data + j for s in range(n_dcn)])
        if rank % n_data == j:
            dcn_group = g
    return DataMesh(n_dcn, n_data, rank, world_group, data_group, dcn_group)


def parse_mesh_spec(spec) -> Optional[DataMesh]:
    """Resolve the runner's and command line's ``mesh`` argument.

    A :class:`DataMesh` is returned as it is; ``None``, ``''``, ``'none'``
    and ``'1'`` give None (one process, no mesh). ``'auto'``: the whole
    world as the data axis, or, where torchrun says the world spans several
    hosts (``LOCAL_WORLD_SIZE`` dividing it), one slice per host; None when
    no process group is initialized or the world is one. ``'data=N'``,
    optionally with ``dcn=K``: N x K must equal the world size. The specs
    accepted and refused, and the errors, are the JAX package's
    (``parallel/sharding.py`` ``parse_mesh_spec``); ``model=M`` with M > 1
    and ``stage=K`` raise ``NotImplementedError`` (not ported yet)."""
    if spec is None or isinstance(spec, DataMesh):
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
    if sizes["stage"]:
        if sizes["data"] > 1 or sizes["model"] > 1 or sizes["dcn"] > 1:
            raise ValueError(
                f"mesh {spec!r}: the 'stage' (pipeline) axis cannot be "
                "combined with 'dcn'/'data'/'model' — the GPipe schedule "
                "owns its whole mesh"
            )
        raise NotImplementedError(
            f"mesh {spec!r}: the pipeline ('stage') axis is not ported yet"
        )
    if sizes["model"] > 1:
        raise NotImplementedError(
            f"mesh {spec!r}: the model (head) axis is not ported yet"
        )
    world = _world()
    if sizes["dcn"] * sizes["data"] != world:
        raise ValueError(
            f"mesh {spec!r} needs {sizes['dcn'] * sizes['data']} devices but "
            f"only {world} are visible (the world size of the default process group)"
        )
    return make_mesh(n_data=sizes["data"], n_dcn=sizes["dcn"])


def data_axis_size(mesh: Optional[DataMesh]) -> int:
    """Total batch-sharding ways: the data axis times the dcn axis (1 for
    no mesh)."""
    return 1 if mesh is None else mesh.world


def _rows(n: int, k: int, i: int) -> slice:
    if n % k:
        raise ValueError(f"{n} rows are not divisible over {k} ranks")
    return slice(i * n // k, (i + 1) * n // k)


def shard_rows(mesh: DataMesh, a):
    """This rank's rows of ``a``: rank r of n takes ``[r B / n, (r + 1) B
    / n)`` of the leading axis (a view)."""
    return a[_rows(a.shape[0], mesh.world, mesh.rank)]


def shard_batch(mesh: DataMesh, batch: dict) -> dict:
    """This rank's rows (:func:`shard_rows`) of every variable of a batch
    dict."""
    return {k: shard_rows(mesh, v) for k, v in batch.items()}


def all_reduce(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over the data group, then over the dcn group: the
    two-level gradient all-reduce (within a slice first, then one hop
    across slices). Nothing to do without a process group."""
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
        flat /= mesh.world
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
