"""Frames-parallel enhancement over a 1-D ``seq`` mesh (port of
diffse_tpu/parallel/sequence.py).

One utterance's spectrogram ``[B, C, F, T]`` is split along its frames (the
last axis, the ``W`` of the kernels' NHWC) over the ranks of a 1-D mesh, so
that a long utterance is one program over several devices. The JAX package
pins the frames axis to its mesh after the STFT and lets GSPMD partition the
U-Net and the sampler; here each rank runs the same model on its frames and
the layers consult the enclosing shard (``constrain_frames``,
``current_frames``) for the collectives GSPMD would insert:

  - every conv and FIR resample reads its neighbours' edge columns
    (``FramesShard.halo``), none past the global edges;
  - GroupNorm's statistics are each rank's group sums, summed over the
    shards in float64 before the affine is folded (``FramesShard.sum``);
  - the attention's keys and values are gathered over the frames;
  - the samplers' norms and maxima are reduced over the shards;
  - an NCSN++ level whose frames do not divide over the ranks runs whole on
    every rank (``FrameLevels``), as GSPMD replicates it;
  - DCUNet's levels, whose widths are odd (its input padded to ``(T - 1) %
    time_prod == 0``, its "auto" paddings of even kernels, the decoder's
    exact output sizes), split unevenly instead (``split_bounds``: at most
    ``ceil(W / n)`` columns a rank, as GSPMD splits an uneven dimension):
    each complex conv and transposed conv reads the input columns its part
    of the output reaches, from whichever ranks hold them
    (``FramesShard.columns``, zeros past the global edges, where the
    explicit padding applies), and "CbN" whitens by the whole map's five
    moments, each rank's sums all-reduced in float64 (``FramesShard.sum``).

Every rank computes the STFT of the whole waveform and keeps its frames,
draws every random tensor at the whole shape and keeps its frames (so a
sharded run sees the one-device noise), and gathers the frames before the
iSTFT: each rank returns the whole waveform.

The collectives are all-reduce and all-gather, which gloo takes on CUDA
tensors (several ranks on one card) as NCCL does on cards of their own; a
halo is an all-gather of the ranks' edge columns, with no point-to-point
send.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import Collectives, _device_type, init_single_process

SEQ = "seq"


def make_seq_mesh(n_seq: Optional[int] = None, device_type: Optional[str] = None,
                  axis_name: str = SEQ) -> DeviceMesh:
    """1-D mesh over the first ``n_seq`` ranks of the process group (all of
    them when None; one of this process alone when there is no group).
    Raises ``ValueError`` when ``n_seq`` exceeds the world size.
    ``device_type``: "cuda" where a card is present, else "cpu", unless
    given."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_seq is not None and n_seq > world:
        raise ValueError(f"need {n_seq} ranks, have {world}")
    device_type = _device_type(device_type)
    init_single_process(device_type)
    n = world if n_seq is None else n_seq
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis_name,))


def mesh_key(mesh: DeviceMesh) -> tuple:
    """What a program over ``mesh`` depends on: its axis names, shape and
    ranks (the JAX package's cache key of a mesh)."""
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()))


def spec_seq_sharding(mesh: DeviceMesh, frames: int, axis_name: Optional[str] = None) -> slice:
    """The frames this rank keeps of a ``[B, C, F, frames]`` spectrogram:
    part ``i`` of ``n`` equal contiguous parts for the rank at index ``i`` of
    the mesh's axis (its first unless named)."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    count, index = mesh.size(mesh.mesh_dim_names.index(axis_name)), mesh.get_local_rank(axis_name)
    if frames % count:
        raise ValueError(f"{frames} frames do not divide over {count} ranks")
    k = frames // count
    return slice(index * k, (index + 1) * k)


def split_bounds(width: int, count: int) -> tuple:
    """The column bounds of a map ``width`` frames wide split unevenly over
    ``count`` ranks: rank ``r`` holds ``[bounds[r], bounds[r + 1])`` with
    ``bounds[r] = ceil(r * width / count)``, so at most ``ceil(width /
    count)`` columns, as GSPMD splits an uneven dimension (its own split over
    two ranks), and at least ``floor(width / count)``, so that no rank is
    empty. Raises where ``width < count``."""
    if width < count:
        raise ValueError(f"{width} frames do not split over {count} ranks")
    return tuple(-(-r * width // count) for r in range(count + 1))


class FramesShard(NamedTuple):
    """This rank's part of the frames: part ``index`` of ``count`` equal
    contiguous parts of the last axis of the top level's maps, the ranks of
    ``coll``'s group holding the others."""

    index: int
    count: int
    coll: Collectives

    def frames(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's frames of a tensor holding all of them along ``dim``."""
        k = t.shape[dim] // self.count
        return t.narrow(dim, self.index * k, k)

    def global_like(self, x: torch.Tensor) -> torch.Tensor:
        """An empty tensor of the whole frames' shape (last axis), ``x``'s
        dtype and device."""
        return x.new_empty((*x.shape[:-1], x.shape[-1] * self.count))

    def draws(self, noise: Callable[[torch.Tensor], torch.Tensor]):
        """A noise source (``noise(like)``) that draws at the whole frames'
        shape, as the one-device program draws, and keeps this rank's."""
        def shard_noise(like):
            return self.frames(noise(self.global_like(like))).contiguous()
        return shard_noise

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in rank order."""
        moved = t.movedim(dim, 0)
        return self.coll.all_gather(moved).movedim(0, dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, a new tensor."""
        return self.coll.all_reduce_(t.detach().contiguous().clone())

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise maximum over the ranks, a new tensor."""
        out = t.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.coll.group)
        return out

    def halo(self, t: torch.Tensor, dim: int, left: int, right: int,
             zero_edges: bool = True):
        """``t`` extended along ``dim`` by ``left`` columns of the rank
        before and ``right`` of the rank after. Past the global edges: zero
        columns (``zero_edges``, the zero padding of a map), returning the
        tensor; or none, returning ``(tensor, left, right)`` with the columns
        that were added. One all-gather of every rank's edge columns."""
        width = t.shape[dim]
        if width < max(left, right):
            raise ValueError(f"a halo of {left}/{right} columns from a shard of {width}")
        block = torch.cat([t.narrow(dim, 0, right), t.narrow(dim, width - left, left)], dim)
        edges = self.gather(block, dim)
        per = left + right
        parts = [t]
        added_left = left if self.index > 0 else 0
        added_right = right if self.index < self.count - 1 else 0
        if added_left:
            parts.insert(0, edges.narrow(dim, (self.index - 1) * per + right, left))
        if added_right:
            parts.append(edges.narrow(dim, (self.index + 1) * per, right))
        if zero_edges:
            shape = list(t.shape)
            if left and not added_left:
                shape[dim] = left
                parts.insert(0, t.new_zeros(shape))
            if right and not added_right:
                shape[dim] = right
                parts.append(t.new_zeros(shape))
        out = torch.cat(parts, dim)
        return out if zero_edges else (out, added_left, added_right)

    def columns(self, t: torch.Tensor, bounds: tuple, spans, dim: int = -1) -> torch.Tensor:
        """Columns ``[lo, hi) = spans[self.index]`` along ``dim`` of the whole
        map of which ``t`` holds this rank's part, the map split at ``bounds``
        (rank ``r`` holding ``[bounds[r], bounds[r + 1])``); zeros past the
        whole map's edges ``[0, bounds[-1])``. Every rank calls it at once
        with every rank's span (``spans``, the same on each). One all-gather
        of each rank's first and last ``m`` columns, ``m`` the most any rank
        reads past its own part (none where no rank does); a span that reads
        a column farther than ``m`` from its holder's edges raises."""
        if t.is_complex():
            return torch.view_as_complex(
                self.columns(torch.view_as_real(t), bounds, spans, dim % t.ndim).contiguous())
        dim = dim % t.ndim
        width = bounds[-1]
        if t.shape[dim] != bounds[self.index + 1] - bounds[self.index]:
            raise ValueError(f"a shard of {t.shape[dim]} columns where bounds {bounds} give "
                             f"rank {self.index} {bounds[self.index + 1] - bounds[self.index]}")

        def outside(r):  # columns of [0, width) rank r reads left and right of its part
            (lo, hi), b0, b1 = spans[r], bounds[r], bounds[r + 1]
            return (max(0, min(b0, hi) - max(lo, 0)), max(0, min(hi, width) - max(lo, b1)))

        m = max(max(outside(r)) for r in range(self.count))
        own, lo, hi = bounds[self.index], *spans[self.index]
        zero = t.shape[dim]  # the zero column's index in the source below
        parts = [t, t.new_zeros((*t.shape[:dim], 1, *t.shape[dim + 1:]))]
        if m:
            w = t.shape[dim]
            first = t.narrow(dim, 0, min(m, w))
            last = t.narrow(dim, w - min(m, w), min(m, w))
            pad = [0] * (2 * (t.ndim - dim - 1))
            block = torch.cat([torch.nn.functional.pad(first, pad + [0, m - first.shape[dim]]),
                               torch.nn.functional.pad(last, pad + [m - last.shape[dim], 0])],
                              dim)
            parts.append(self.gather(block, dim))
        index = []
        for g in range(lo, hi):
            if g < 0 or g >= width:
                index.append(zero)
                continue
            q = bisect.bisect_right(bounds, g) - 1
            if q == self.index:
                index.append(g - own)
            elif g - bounds[q] < m:
                index.append(zero + 1 + q * 2 * m + g - bounds[q])
            elif bounds[q + 1] - g <= m:
                index.append(zero + 1 + q * 2 * m + 2 * m - (bounds[q + 1] - g))
            else:
                raise ValueError(f"column {g} lies {m} columns or more inside rank {q}'s part")
        source = torch.cat(parts, dim)
        return source.index_select(dim, torch.tensor(index, dtype=torch.long,
                                                     device=t.device))


_active = threading.local()


def current_frames() -> Optional[FramesShard]:
    """The frames shard of the enclosing ``constrain_frames`` block, if any
    (None also inside a level that runs whole, ``FrameLevels``)."""
    return getattr(_active, "frames", None)


@contextlib.contextmanager
def _set_frames(shard: Optional[FramesShard]):
    previous = current_frames()
    _active.frames = shard
    try:
        yield shard
    finally:
        _active.frames = previous


def frames_shard(mesh: Optional[DeviceMesh], axis_name: Optional[str] = None):
    """This rank's ``FramesShard`` over the mesh's ``axis_name`` (its first
    unless named); None without a mesh or where the axis has one rank."""
    if mesh is None:
        return None
    axis_name = axis_name or mesh.mesh_dim_names[0]
    count = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if count == 1:
        return None
    return FramesShard(mesh.get_local_rank(axis_name), count,
                       Collectives(mesh.get_group(axis_name)))


def constrain_frames(mesh: Optional[DeviceMesh], axis_name: Optional[str] = None):
    """The counterpart of the JAX function of this name: inside the block
    the maps' frames are this rank's part of the whole, split over the
    mesh's ``axis_name`` (``frames_shard``), and the layers, the samplers and
    ``ScoreModel`` exchange and reduce over it. No change where the axis has
    one rank (or there is no mesh). Yields the shard."""
    return _set_frames(frames_shard(mesh, axis_name))


class FrameLevels:
    """Which levels of a U-Net run split over the frames shard: the levels,
    from the top, whose frames divide into ``count`` parts (the top level
    holds ``frames`` per rank and each level below half as many in all);
    below the first that does not, every level runs whole on every rank.
    Without a shard every level runs as on one device and the methods
    change nothing."""

    def __init__(self, frames: int, depth: int):
        self.shard = current_frames()
        self.split: List[bool] = []
        if self.shard is not None:
            total = frames * self.shard.count
            for i in range(depth):
                width, rest = divmod(total, 2 ** i)
                self.split.append(rest == 0 and width % self.shard.count == 0
                                  and (i == 0 or self.split[-1]))

    def level(self, i: int):
        """The block in which the layers see level ``i``'s layout: the shard,
        or none for a level that runs whole."""
        if self.shard is None:
            return contextlib.nullcontext()
        return _set_frames(self.shard if self.split[i] else None)

    def down(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """``t`` (in level ``i``'s layout) in level ``i + 1``'s: gathered where
        level ``i + 1`` runs whole and level ``i`` does not."""
        if self.shard is not None and self.split[i] and not self.split[i + 1]:
            return self.shard.gather(t).contiguous(memory_format=torch.channels_last)
        return t

    def up(self, fn: Callable[[torch.Tensor], torch.Tensor], t: torch.Tensor,
           i: int) -> torch.Tensor:
        """``fn(t)`` run at level ``i`` (a resampling up to level ``i - 1``),
        its result in level ``i - 1``'s layout: this rank's frames where level
        ``i - 1`` is split and level ``i`` is not."""
        with self.level(i):
            out = fn(t)
        if self.shard is not None and self.split[i - 1] and not self.split[i]:
            return self.shard.frames(out)
        return out
