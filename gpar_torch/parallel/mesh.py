"""The device mesh of one process and its collectives.

The JAX package's mesh is a ``jax.sharding.Mesh`` driven by ``shard_map``
from a single process (``gpar_tpu/parallel/sharded.py:52-83``): every shard
is addressable from that process.  The port keeps that contract without a
``torch.distributed`` group: a :class:`Mesh` is a tuple of
``torch.device``s, repeats allowed, and a sharded tensor is a list of
per-shard tensors, shard ``s`` on ``mesh.devices[s]``.  A mesh of one card
named four times is a *virtual* mesh, as the JAX tests run eight virtual
CPU devices: every shard's work runs on that card, one shard after the
other, and every move between shards is a no-op.

The collectives are plain functions over such lists:

- :func:`psum`: each shard's tensor moved to shard 0's device and added in
  shard order 0..P-1, a fixed order, so repeated runs give the same bits;
- :func:`all_gather`: the shards concatenated along an axis, once per
  distinct device;
- :func:`broadcast`: one tensor placed on every shard's device.

Autograd flows through all three (``Tensor.to`` and ``torch.cat`` are
differentiable), so a sharded objective needs no hand-written backward.
"""

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["Mesh", "canonical", "split_rows", "psum", "all_gather", "broadcast", "devices_of",
           "to_device"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, repeats
    allowed) along the axis ``axis_names[0]``."""

    devices: tuple
    axis_names: tuple = ("dp",)

    @property
    def size(self):
        return len(self.devices)

    @property
    def home(self):
        """Shard 0's device, where replicated values are computed."""
        return self.devices[0]

    @property
    def virtual(self):
        """Whether every shard lies on one device."""
        return len(set(self.devices)) == 1


def canonical(device):
    """``device`` with its index: ``cuda`` means the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def split_rows(t, mesh, dim=0):
    """``t`` cut along ``dim`` into ``mesh.size`` contiguous equal blocks,
    block ``s`` on shard ``s``'s device (a view where it already is)."""
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards; pad them first")
    return [c.to(d) for c, d in zip(torch.split(t, n // mesh.size, dim=dim), mesh.devices)]


def psum(parts):
    """The sum of the per-shard tensors ``parts`` on shard 0's device, added
    in shard order."""
    home = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(home)
    return acc


def all_gather(parts, dim=0):
    """The shards ``parts`` concatenated along ``dim``, on every shard's
    device: one concatenation per distinct device, shared by the shards
    that lie on it."""
    out = {}
    for p in parts:
        if p.device not in out:
            out[p.device] = torch.cat([q.to(p.device) for q in parts], dim=dim)
    return [out[p.device] for p in parts]


def broadcast(t, devices):
    """``t`` on each of ``devices`` (a mesh's, or the devices of a list of
    shards)."""
    return [t.to(d) for d in devices]


def devices_of(parts):
    """The devices of per-shard tensors."""
    return [p.device for p in parts]


def to_device(obj, device):
    """``obj`` with every tensor moved to ``device``: a tensor, a kernel tree
    (frozen dataclasses), or a dict, list or tuple of them; anything else
    passes through.  Differentiable, and a no-op on ``device`` itself."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: to_device(getattr(obj, f.name), device)
                   for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **changes)
    return obj
