"""Process groups, the device mesh and the collectives of a train step (port
of diffse_tpu/parallel/mesh.py).

The reference's only parallelism is data-parallel DDP over NCCL (sgmse
train.py:108: ``DDPPlugin(find_unused_parameters=False)``). The JAX package
runs it as a 1-D ``Mesh`` over a ``"data"`` axis whose collectives GSPMD
places; here each rank is a process of a ``torch.distributed`` group and
the collectives are explicit:

  - a mesh is a ``DeviceMesh`` over the process group (``make_mesh``; 2-D in
    ``model_sharding.make_2d_mesh``), and the counterparts of the JAX
    shardings are placements, one per mesh axis (``Shard(k)``,
    ``Replicate()``);
  - every rank loads the same global batch, as the JAX processes do, and
    ``shard_batch`` keeps its rows;
  - inside ``batch_shard(mesh)`` the model sees its rows as part of the
    global batch: the loss's random draws are taken at the global batch's
    shape and sliced (``BatchShard.rows``), and batch statistics are means
    over the global batch (``batch_mean``), so that a data-parallel step
    computes the one-device step's update;
  - the gradient mean, the loss mean and the stop flag go through
    ``Collectives``.

A CUDA device gets NCCL and the CPU gloo (``default_backend``); NCCL refuses
two ranks on one card, so several ranks on one card run gloo with CUDA
tensors. ``Collectives`` picks its reduce-scatter by the group's backend.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import socket
import threading
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

log = logging.getLogger(__name__)

DATA, MODEL = "data", "model"
# the launcher's variables that configure a coordinator (torchrun sets them)
COORDINATOR_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device="cuda") -> torch.device:
    """This rank's device: for a CUDA device without an index under a
    launcher, card ``LOCAL_RANK`` modulo the cards present (several ranks
    share a card when there are fewer cards than ranks), made current."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def initialize_distributed(device="cuda", backend: Optional[str] = None, **kwargs) -> None:
    """Join the process group (``torch.distributed.init_process_group``) that
    a launcher configured; ``backend`` overrides ``default_backend(device)``,
    ``kwargs`` go to ``init_process_group`` (``init_method``, ``world_size``,
    ``rank``).

    Failure policy, as the JAX package's: already initialised, a no-op; no
    coordinator configured (no ``init_method`` and none of
    ``COORDINATOR_ENV``), one process, logged; a coordinator configured whose
    initialisation fails re-raises, so that a mistyped address never turns a
    multi-process launch into a single-process one."""
    if dist.is_initialized():
        log.info("torch.distributed already initialized; continuing")
        return
    configured = bool(kwargs.get("init_method")) or any(os.environ.get(v)
                                                        for v in COORDINATOR_ENV)
    if not configured and not kwargs:
        log.info("no distributed coordinator configured; running single-process")
        return
    try:
        dist.init_process_group(backend=backend or default_backend(device), **kwargs)
        log.info("torch.distributed initialized: rank %d of %d (%s)", dist.get_rank(),
                 dist.get_world_size(), dist.get_backend())
    except Exception as e:
        if "already initialized" in str(e).lower():
            log.info("torch.distributed already initialized; continuing")
            return
        if configured:
            raise
        log.info("no distributed coordinator configured; running single-process "
                 "(init_process_group said: %s)", e)


def init_single_process(device="cuda", backend: Optional[str] = None) -> None:
    """A process group of this process alone (world size 1, on a free
    localhost port), unless one exists: a mesh of one rank."""
    if not dist.is_initialized():
        dist.init_process_group(backend=backend or default_backend(device),
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_rank() -> bool:
    """True on rank 0 and in a process outside any group: the rank that logs
    and writes."""
    return world_rank() == 0


def _device_type(device_type: Optional[str]) -> str:
    """``device_type``, or "cuda" where a card is present, else "cpu". For
    CUDA, this process's current card is made its device first, so that the
    mesh does not pick one by rank."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    return device_type


def make_mesh(device_type: Optional[str] = None, axis_name: str = DATA) -> DeviceMesh:
    """1-D data-parallel mesh over every rank of the process group (one of
    this process alone when there is none). ``device_type``: "cuda" where
    a card is present, else "cpu", unless given."""
    device_type = _device_type(device_type)
    init_single_process(device_type)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def _placements(mesh: DeviceMesh, **by_axis) -> tuple:
    return tuple(by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh, axis_name: str = DATA) -> tuple:
    """The batch (leading) axis sharded over ``axis_name``."""
    return _placements(mesh, **{axis_name: Shard(0)})


def microbatch_sharding(mesh: DeviceMesh, axis_name: str = DATA) -> tuple:
    """Axis 1 sharded: gradient-accumulation batches ``(accum, b, ...)``."""
    return _placements(mesh, **{axis_name: Shard(1)})


def stacked_batch_sharding(mesh: DeviceMesh, lead_axes: int, axis_name: str = DATA) -> tuple:
    """Axis ``lead_axes`` sharded: batches stacked under that many leading
    axes (``chain_steps`` and/or ``accum_steps``)."""
    return _placements(mesh, **{axis_name: Shard(lead_axes)})


def replicated_sharding(mesh: DeviceMesh) -> tuple:
    return _placements(mesh)


def _rows(a, axis: int, index: int, count: int):
    size = a.shape[axis]
    if size % count:
        raise ValueError(f"a batch axis of {size} does not divide over {count} ranks")
    k = size // count
    picked = a[(slice(None),) * axis + (slice(index * k, (index + 1) * k),)]
    return np.ascontiguousarray(picked) if isinstance(picked, np.ndarray) else picked


def shard_batch(mesh: Optional[DeviceMesh], batch, lead_axes: int = 0, axis_name: str = DATA):
    """This rank's rows of a global batch (a tuple, list or dict of numpy
    arrays or tensors): axis ``lead_axes`` split in equal contiguous parts
    over the mesh's ``axis_name``, part ``i`` to the rank at index ``i``."""
    count, index = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    if count == 1:
        return batch
    if isinstance(batch, dict):
        return {k: _rows(v, lead_axes, index, count) for k, v in batch.items()}
    return type(batch)(_rows(v, lead_axes, index, count) for v in batch)


class Collectives:
    """The collectives a step needs, over one process group (the default
    one when ``group`` is None), each chosen by the group's backend before
    anything is sent. Both backends take the tensors where they lie (gloo
    takes CUDA tensors for every collective used here); under gloo a
    reduce-scatter is an all-reduce of which each rank keeps its part
    (gloo has no ``reduce_scatter_tensor`` on every torch version)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.nccl = str(dist.get_backend(group)) == "nccl"

    def _flag_device(self) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device()) if self.nccl else \
            torch.device("cpu")

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in place (``t`` contiguous)."""
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``t`` on every rank, in place."""
        root = src if self.group is None else dist.get_global_rank(self.group, src)
        dist.broadcast(t, root, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on dim 0, in group rank order."""
        t = t.contiguous()
        if self.nccl:
            out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group of ``t``, of which this rank gets part
        ``rank`` of ``size`` equal parts of dim 0."""
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {t.shape[0]} does not divide over {self.size} ranks")
        if self.nccl:
            out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
            dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
            return out
        total = self.all_reduce_(t.contiguous().clone())
        return total.chunk(self.size)[self.rank].clone()

    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the group: one
        collective over one flat buffer (one per dtype)."""
        _coalesced(tensors, lambda flat: self.all_reduce_(flat).div_(self.size))

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s mean over the group, a new tensor."""
        out = t.detach().clone()
        self.mean_([out])
        return out

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self._flag_device())
        self.all_reduce_(t)
        return bool(t.item())

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Group rank ``src``'s ``obj`` (picklable) on every rank."""
        root = src if self.group is None else dist.get_global_rank(self.group, src)
        box = [obj]
        dist.broadcast_object_list(box, src=root, group=self.group)
        return box[0]


@torch.no_grad()
def _coalesced(tensors: Sequence[torch.Tensor], op) -> None:
    """``op`` on one flat copy of ``tensors`` per dtype, in place, each
    tensor then given its part back."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset: offset + t.numel()].view(t.shape))
            offset += t.numel()


def world_collectives() -> Optional[Collectives]:
    """Collectives over every rank, or None outside a group of several."""
    return Collectives() if world_size() > 1 else None


def replicate(mesh: Optional[DeviceMesh], module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place; returns
    ``module``."""
    if mesh is None or world_size() == 1:
        return module
    _coalesced([*module.parameters(), *module.buffers()], Collectives().broadcast_)
    return module


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, whose gradient is the sum of the gradients over
    the group: each rank's loss depends on every rank's share of a global
    statistic."""

    @staticmethod
    def forward(ctx, coll: Collectives, t: torch.Tensor):
        ctx.coll = coll
        return coll.all_reduce_(t.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.coll.all_reduce_(grad.contiguous().clone())


def all_reduce_sum(t: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """The differentiable sum of ``t`` over ``coll``'s group."""
    return _AllReduceSum.apply(coll, t)


class BatchShard(NamedTuple):
    """This rank's part of the global batch: part ``index`` of ``count``
    equal contiguous parts of dim 0, the ranks of ``coll``'s group holding
    the others."""
    index: int
    count: int
    coll: Collectives

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor drawn at the global batch's shape."""
        k = t.shape[0] // self.count
        return t[self.index * k: (self.index + 1) * k]

    def global_like(self, x: torch.Tensor) -> torch.Tensor:
        """An empty tensor of the global batch's shape, ``x``'s dtype and device."""
        return x.new_empty((x.shape[0] * self.count, *x.shape[1:]))

    def keep_mask(self, draw):
        """A keep-mask source (``models.layers.KeepMask``) that draws at the
        global batch's shape and keeps this rank's rows."""
        def keep_mask(shape, keep, device):
            return self.rows(draw((shape[0] * self.count, *shape[1:]), keep, device))
        return keep_mask


_active = threading.local()


def current_shard() -> Optional[BatchShard]:
    """The batch shard of the enclosing ``batch_shard`` block, if any."""
    return getattr(_active, "shard", None)


@contextlib.contextmanager
def batch_shard(mesh: Optional[DeviceMesh], axis_name: str = DATA):
    """Inside the block the batch is this rank's rows of the global batch,
    split over the mesh's ``axis_name`` (``shard_batch``): the loss draws at
    the global shape and keeps its rows, and ``batch_mean`` averages over
    the global batch. No change where the axis has one rank (or there is no
    mesh)."""
    count = axis_size(mesh, axis_name)
    shard = None if count == 1 else BatchShard(axis_index(mesh, axis_name), count,
                                               Collectives(mesh.get_group(axis_name)))
    previous = current_shard()
    _active.shard = shard
    try:
        yield shard
    finally:
        _active.shard = previous


def batch_mean(x: torch.Tensor, dims: Sequence[int], keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)`` (``dims`` holding the batch axis 0) over the global
    batch inside a ``batch_shard`` block: the sums all-reduced over the
    data axis, differentiably; ``x.mean`` elsewhere."""
    shard = current_shard()
    if shard is None:
        return x.mean(dim=tuple(dims), keepdim=keepdim)
    n = math.prod(x.shape[d] for d in dims) * shard.count
    return all_reduce_sum(x.sum(dim=tuple(dims), keepdim=keepdim), shard.coll) / n
