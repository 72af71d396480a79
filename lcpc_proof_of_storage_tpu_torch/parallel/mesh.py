"""Device meshes and their collectives, in one process.

Stands in for ``jax.sharding.Mesh`` and the collectives that the JAX
package's ``parallel/`` runs under ``shard_map`` (``all_to_all``,
``all_gather``; the ``psum`` of a collapse is K3's accumulator chain,
``parallel/sharded.py``).  One controller drives every shard, as in JAX:

* a :class:`Mesh` is a tuple of torch devices along one axis.  A device may
  repeat: a mesh of 4 shards on ``cuda:0`` runs every collective on a
  one-card machine, and with several cards :func:`make_mesh` spreads the
  shards over ``cuda:0 .. k-1``;
* a sharded tensor is the list of its per-shard tensors, shard k on
  ``mesh.devices[k]``;
* the collectives move shard pieces with ``.to(device)`` and join them with
  ``torch.cat``.  No process group is involved.
"""

from __future__ import annotations

import torch


class Mesh:
    """A one-axis mesh: ``devices[k]`` holds shard k."""

    def __init__(self, devices):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index, as a tensor on it reports it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of `n_devices` shards: all on `device` where it is given (e.g.
    ``make_mesh(4, device="cpu")``; default one shard), else spread over the
    visible CUDA cards in turn (default one shard a card).  With no card and
    no device this raises: no mesh falls back to the CPU by itself."""
    if device is not None:
        return Mesh([device] * (1 if n_devices is None else n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' for a mesh of "
                           "CPU shards")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    return Mesh([torch.device("cuda", k % count) for k in range(n)])


def shard_slices(n: int, shards: int) -> list[slice]:
    """`shards` contiguous blocks of range(n), ceil(n / shards) long but the
    last ones, which may be shorter or empty."""
    step = -(-n // shards)
    return [slice(min(k * step, n), min((k + 1) * step, n)) for k in range(shards)]


def scatter(x: torch.Tensor, mesh: Mesh, dim: int, width: int | None = None
            ) -> list[torch.Tensor]:
    """x zero-padded along `dim` to `width` (default: its own) and cut into
    the blocks of :func:`shard_slices`, block k a new contiguous tensor on
    ``mesh.devices[k]``."""
    n = x.shape[dim]
    width = n if width is None else width
    if width < n:
        raise ValueError(f"scatter: width {width} below the tensor's {n}")
    out = []
    for s, dev in zip(shard_slices(width, mesh.size), mesh.devices):
        shape = list(x.shape)
        shape[dim] = s.stop - s.start
        block = torch.zeros(shape, dtype=x.dtype, device=dev)
        take = max(0, min(s.stop, n) - s.start)
        if take:
            block.narrow(dim, 0, take).copy_(x.narrow(dim, s.start, take))
        out.append(block)
    return out


def gather(shards: list[torch.Tensor], device, dim: int) -> torch.Tensor:
    """The shards joined along `dim` on one device."""
    return torch.cat([s.to(device) for s in shards], dim=dim)


def all_gather(shards: list[torch.Tensor], mesh: Mesh, dim: int) -> list[torch.Tensor]:
    """Every shard gets the shards joined along `dim`, on its own device
    (``jax.lax.all_gather(tiled=True)``).  Shards on one device share the
    joined tensor: read it, do not write it."""
    joined: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in joined:
            joined[dev] = gather(shards, dev, dim)
    return [joined[dev] for dev in mesh.devices]


def all_to_all(shards: list[torch.Tensor], mesh: Mesh, split_dim: int,
               concat_dim: int) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(tiled=True)``: each shard's `split_dim` is cut
    into mesh.size equal pieces, and shard j gets piece j of every shard,
    joined along `concat_dim` in shard order, on its device."""
    D = mesh.size
    if len(shards) != D or any(s.shape[split_dim] % D for s in shards):
        raise ValueError(f"all_to_all: {len(shards)} shards of {[tuple(s.shape) for s in shards]}"
                         f" do not split {D} ways along dim {split_dim}")
    pieces = [s.chunk(D, dim=split_dim) for s in shards]
    return [torch.cat([pieces[i][j].to(dev) for i in range(D)], dim=concat_dim)
            for j, dev in enumerate(mesh.devices)]
