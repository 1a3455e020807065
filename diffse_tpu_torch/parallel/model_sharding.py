"""Tensor (model)-parallel state over a 2-D ``(data, model)`` mesh (port of
diffse_tpu/parallel/model_sharding.py).

The layout is the JAX package's: each conv and dense weight is sharded on
its output-feature axis over ``"model"``, and so are the 1-D biases and
norm scales, where that axis divides; everything else is replicated. Its
rule names flax leaves; here it is read through the layouts that
``convert.py`` maps them by:

- a flax ``kernel`` is the ``weight`` of an ``nn.Conv2d`` (HWIO -> OIHW) or
  an ``nn.Linear`` ((in, out) -> [out, in]): its output axis, the flax
  kernel's last, is dim 0 here; a 4-D conv and a 2-D dense weight shard,
  as in JAX;
- a flax ``bias``, and a norm's ``scale`` (GroupNorm's, BatchNorm's: a 1-D
  ``weight`` here), shard on dim 0;
- a FIR conv's ``weight`` (flax names it ``weight``, not ``kernel``), an
  embedding table, NIN's ``W``/``b``, the Fourier features' ``W``, the
  transposed convs' ``w_re``/``w_im``, the LSTM's weights, the BatchNorm
  running statistics (buffers) and scalars are replicated.

The rule reads names and shapes, so the parameters, the EMA shadow and
Adam's two moments, which mirror them, get the same layout.

The compute: at rest each rank keeps its shard of the sharded parameters'
training state (its slice of the weight, of the EMA and of Adam's moments);
the module's own parameters hold the whole weights, all-gathered over
``"model"`` after each update. So the forward and the backward, and every
hand kernel in them, run on whole weights exactly as on one device. The
whole gradients are then reduce-scattered over ``"model"`` and averaged
over ``"data"``; Adam and the EMA update only the local shards. That is the
JAX package's state layout; how GSPMD lays out the compute is its own
business (its rules "only decide layout"), and computing on channel slices
is a later choice about speed, not about the maths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from .mesh import DATA, MODEL, Collectives, _device_type, axis_index, axis_size, world_size


def make_2d_mesh(n_data: int, n_model: int, device_type: Optional[str] = None,
                 axis_names=(DATA, MODEL)) -> DeviceMesh:
    """``(data, model)`` mesh over the process group's ``n_data * n_model``
    ranks: rank ``r`` at ``(r // n_model, r % n_model)``."""
    need = n_data * n_model
    if world_size() != need:
        raise ValueError(f"need {need} ranks for a {n_data}x{n_model} mesh, "
                         f"have {world_size()}")
    return init_device_mesh(_device_type(device_type), (n_data, n_model),
                            mesh_dim_names=tuple(axis_names))


def leaf_partition_spec(owner: nn.Module, name: str, leaf: torch.Tensor, n_model: int):
    """The placement over ``"model"`` of the parameter ``name`` of module
    ``owner`` (module docstring): ``Shard(0)`` or ``Replicate()``."""
    shape = tuple(leaf.shape)
    if not shape or shape[0] % n_model:
        return Replicate()
    if name == "weight":
        kernel = ((isinstance(owner, nn.Conv2d) and len(shape) == 4)
                  or (isinstance(owner, nn.Linear) and len(shape) == 2))
        scale = len(shape) == 1 and not isinstance(owner, nn.Embedding)
        return Shard(0) if kernel or scale else Replicate()
    if name == "bias" and len(shape) == 1:
        return Shard(0)
    return Replicate()


def partition_specs(module: nn.Module, n_model: int) -> Dict[str, object]:
    """``leaf_partition_spec`` of every parameter of ``module``, by name."""
    owners = dict(module.named_modules())
    specs = {}
    for full, p in module.named_parameters():
        owner, _, name = full.rpartition(".")
        specs[full] = leaf_partition_spec(owners[owner], name, p, n_model)
    return specs


def tree_shardings(mesh: DeviceMesh, module: nn.Module, model_axis: str = MODEL) -> dict:
    """Every parameter's placements, one per mesh axis, by name: the rule's
    on ``model_axis``, ``Replicate()`` on the others. The EMA and Adam's
    moments take their parameter's."""
    n_model = axis_size(mesh, model_axis)
    return {name: tuple(spec if axis == model_axis else Replicate()
                        for axis in mesh.mesh_dim_names)
            for name, spec in partition_specs(module, n_model).items()}


def local_shard(t: torch.Tensor, placement, n: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``n`` of ``t`` under ``placement`` (a view)."""
    if isinstance(placement, Shard):
        k = t.shape[placement.dim] // n
        return t.narrow(placement.dim, index * k, k)
    return t


def shard_tree(mesh: DeviceMesh, tensors: Dict[str, torch.Tensor], shardings: dict,
               model_axis: str = MODEL) -> Dict[str, torch.Tensor]:
    """This rank's shard of each named tensor under ``shardings``
    (``tree_shardings``' output)."""
    n, index = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    axis = mesh.mesh_dim_names.index(model_axis)
    return {name: local_shard(t, shardings[name][axis], n, index) if name in shardings else t
            for name, t in tensors.items()}


def shard_state(mesh: DeviceMesh, state):
    """``state`` (a ``train.TrainState``) laid out over ``mesh``, in place;
    returns it."""
    state.shard(mesh)
    return state


def shard_variables(mesh: DeviceMesh, module: nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's shard of each of ``module``'s parameters, by name."""
    return shard_tree(mesh, dict(module.named_parameters()), tree_shardings(mesh, module))


state_shardings = tree_shardings
variables_shardings = tree_shardings


class StateLayout:
    """Where the trained parameters ``params`` (named ``names``, of
    ``module``) live over ``mesh``, and the collectives that keep them: the
    gradient reduction, the all-gather of the updated shards, the gathering
    of a sharded tensor whole. Over a 1-D mesh nothing is sharded."""

    def __init__(self, mesh: DeviceMesh, module: nn.Module, names: Sequence[str],
                 params: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.world = Collectives()
        if set(mesh.mesh_dim_names) - {DATA, MODEL}:
            raise ValueError(f"mesh axes {mesh.mesh_dim_names}: the state takes 'data' and "
                             "'model'")
        self.n_model, self.model_index = axis_size(mesh, MODEL), axis_index(mesh, MODEL)
        self.n_data = axis_size(mesh, DATA)
        if self.n_data * self.n_model != self.world.size:
            raise ValueError("the mesh must span every rank of the process group")
        self.model = Collectives(mesh.get_group(MODEL)) if self.n_model > 1 else None
        self.data = Collectives(mesh.get_group(DATA)) if DATA in mesh.mesh_dim_names else None
        specs = partition_specs(module, self.n_model)
        self.sharded = [self.n_model > 1 and isinstance(specs[n], Shard) for n in names]
        self.params = list(params)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, shaped like parameter ``i`` (a view)."""
        if not self.sharded[i]:
            return t
        return local_shard(t, Shard(0), self.n_model, self.model_index)

    def whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s tensor whole from this rank's part ``t``: an
        all-gather over ``"model"`` (collective) where it is sharded."""
        return self.model.all_gather(t) if self.sharded[i] else t

    def reduce_gradients(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole per-rank gradients -> the update's: the mean over every
        rank, of the local part where sharded (a reduce-scatter over
        ``"model"``, then an all-reduce over ``"data"``, one flat buffer
        each; the replicated ones one all-reduce over every rank)."""
        out = list(grads)
        replicated = [g for g, s in zip(grads, self.sharded) if not s]
        if replicated:
            self.world.mean_(replicated)
        idx = [i for i, s in enumerate(self.sharded) if s]
        if idx:
            # [model rank 0's parts, model rank 1's parts, ...], flat
            parts = [[g.contiguous().chunk(self.n_model)[m].reshape(-1) for m in
                      range(self.n_model)] for g in (grads[i] for i in idx)]
            flat = torch.cat([p[m] for m in range(self.n_model) for p in parts])
            mine = self.model.reduce_scatter(flat)
            if self.data is not None and self.data.size > 1:
                self.data.all_reduce_(mine)
            mine.div_(self.world.size)
            offset = 0
            for i in idx:
                shape = (grads[i].shape[0] // self.n_model, *grads[i].shape[1:])
                numel = grads[i].numel() // self.n_model
                out[i] = mine[offset: offset + numel].view(shape)
                offset += numel
        return out

    @torch.no_grad()
    def gather_params(self) -> None:
        """Each sharded parameter whole again from every rank's updated
        part: one all-gather over ``"model"``, copied in place (which
        advances the parameter's ``_version``, so caches keyed on it miss)."""
        idx = [i for i, s in enumerate(self.sharded) if s]
        if not idx:
            return
        mine = torch.cat([self.local(i, self.params[i]).reshape(-1) for i in idx])
        every = self.model.all_gather(mine).view(self.n_model, -1)
        offset = 0
        for i in idx:
            p = self.params[i]
            numel = p.numel() // self.n_model
            shape = (p.shape[0] // self.n_model, *p.shape[1:])
            p.copy_(torch.cat([every[m, offset: offset + numel].view(shape)
                               for m in range(self.n_model)]))
            offset += numel
