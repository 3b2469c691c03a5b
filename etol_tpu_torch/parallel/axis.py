"""The collectives of one mesh axis, written out on tensors.

The JAX package writes its sharded bodies for one shard under
``shard_map`` and lets ``lax.psum``, ``lax.ppermute`` and
``lax.axis_index`` name the others. Here a body is written once over a
slab dim of its tensors and takes an axis object for those three:

* :class:`SlabAxis` — all n shards in one process: the slab dim holds n
  slabs of tensors on one device (the port's counterpart of XLA's fake
  host devices; on one card every mesh entry is the card);
* :class:`GroupAxis` — one shard a rank of a ``torch.distributed`` group:
  the slab dim holds this rank's one slab.

Both give ``index`` (the shard indices of the slabs held), ``size``,
``psum`` (a sum over shards, on every shard), ``from_left`` /
``from_right`` (each shard's view of the left / right neighbour's value,
the ring closing at the ends as JAX's ``ppermute`` perms do; callers mask
the wrapped row) and ``gather`` (every shard's value, in shard order).
"""
from __future__ import annotations

import torch


class SlabAxis:
    """n shards stacked on the slab dim of tensors on one device."""

    def __init__(self, n: int):
        self.size = n

    def index(self, device) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def psum(self, x, dim: int = 0):
        return x.sum(dim=dim, keepdim=True).expand_as(x)

    def from_left(self, x, dim: int = 0):
        # perm (i, i+1 mod n): shard i+1 gets shard i's value
        return torch.roll(x, 1, dims=dim)

    def from_right(self, x, dim: int = 0):
        # perm (i, i-1 mod n): shard i-1 gets shard i's value
        return torch.roll(x, -1, dims=dim)

    def gather(self, x, dim: int = 0):
        return x


class GroupAxis:
    """One shard a rank of ``group`` (None: the default group). Gloo
    takes host tensors only, so under gloo a tensor on the card is sent
    through a host copy and comes back to its device; the work stays
    where it was."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._host = dist.get_backend(group) == "gloo"

    def index(self, device) -> torch.Tensor:
        return torch.tensor([self.rank], device=device)

    def _wire(self, x):
        return x.cpu() if self._host else x

    def psum(self, x, dim: int = 0):
        import torch.distributed as dist

        y = self._wire(x).clone()
        dist.all_reduce(y, group=self.group)
        return y.to(x.device)

    def _all(self, x):
        import torch.distributed as dist

        y = self._wire(x).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return [p.to(x.device) for p in parts]

    def from_left(self, x, dim: int = 0):
        return self._all(x)[(self.rank - 1) % self.size]

    def from_right(self, x, dim: int = 0):
        return self._all(x)[(self.rank + 1) % self.size]

    def gather(self, x, dim: int = 0):
        return torch.cat(self._all(x), dim=dim)
