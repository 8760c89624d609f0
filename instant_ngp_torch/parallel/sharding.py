"""Data-parallel training and rendering over a ``torch.distributed`` process
group (port of ``instant_ngp_tpu/parallel/sharding.py``).

The JAX package shards the ray and pixel axis of a device mesh with
``shard_map`` and lets SPMD insert the gradient all-reduce. Here a process
group stands in for the mesh, one process a card (NCCL) or a CPU process
(gloo): the parameters, the optimizer state and the occupancy grid are
replicated (``replicate`` broadcasts them from rank 0 once), every rank takes
its contiguous slice of a batch's leading axis (``shard_batch``, which must
divide evenly, as a ``NamedSharding`` requires), and the gradients are summed
over the group before an optimizer step that every rank then applies alike,
so the parameters stay replicated without more traffic. ``dp_render``
renders a rank's pixels and gathers the frame.

There is no fallback: a function given a group without an initialised
process group raises; a sharded path never runs unsharded.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch
import torch.distributed as dist

# collectives issued through this module, by kind (the dry run reads them)
COLLECTIVES: collections.Counter = collections.Counter()


def check_group(group) -> None:
    """Raise unless ``group`` is a process group of an initialised
    ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised torch.distributed process group "
                           "(torch.distributed.init_process_group); none is")
    if not isinstance(group, dist.ProcessGroup):
        raise RuntimeError(f"a mesh is a torch.distributed ProcessGroup, got {type(group)!r}")


def rank_and_size(group) -> tuple[int, int]:
    check_group(group)
    return dist.get_rank(group), dist.get_world_size(group)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group in place (one collective); returns t."""
    check_group(group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def all_reduce_sum_list(ts: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor of ts summed over the group, as one collective on their
    concatenation (new tensors; ts unchanged)."""
    if not ts:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in ts])
    all_reduce_sum_(flat, group)
    return [f.view(t.shape).to(t.dtype) for f, t in
            zip(torch.split(flat, [t.numel() for t in ts]), ts)]


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' t (equal shapes) concatenated along the leading axis in
    rank order."""
    _, size = rank_and_size(group)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts)


def local_slice(n: int, group) -> slice:
    """This rank's contiguous share of a leading axis of n, which the group
    size must divide."""
    rank, size = rank_and_size(group)
    if n % size:
        raise ValueError(f"a leading axis of {n} does not divide over {size} ranks")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, group):
    """This rank's slice of every tensor of ``batch`` (a tensor, or a dict,
    list or tuple of them) along the leading axis."""
    return _map(lambda t: t[local_slice(t.shape[0], group)], batch)


def replicate(tree, group):
    """Every tensor of ``tree`` broadcast from the group's rank 0, in place;
    returns ``tree``."""
    check_group(group)
    src = dist.get_global_rank(group, 0)

    def bcast(t):
        with torch.no_grad():
            buf = t.detach().contiguous()
            dist.broadcast(buf, src=src, group=group)
            COLLECTIVES["broadcast"] += 1
            if buf.data_ptr() != t.data_ptr():
                t.detach().copy_(buf)
        return t

    return _map(bcast, tree)


def dp_value_and_grad(loss_fn: Callable, group):
    """A data-parallel value and gradient of ``loss_fn(params, batch)``
    (params a list of tensors, batch a tree of tensors with a leading axis
    the group divides): each rank differentiates the mean loss of its slice,
    then the loss and the gradients are averaged over the group by
    all-reduce, identical on every rank (JAX's pmean)."""
    def fn(params, batch):
        _, size = rank_and_size(group)
        params = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = loss_fn(params, shard_batch(batch, group))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        out = all_reduce_sum_list([loss.detach().reshape(1), *grads], group)
        return out[0][0] / size, [g / size for g in out[1:]]

    return fn


def dp_render(render_fn: Callable, group):
    """Shard a per-ray render function across the group: the returned
    function takes per-ray tensors (a leading axis the group divides),
    renders this rank's slice of them with ``render_fn`` (the model state is
    replicated) and gathers every output (a tensor or a tuple of them) in
    rank order."""
    def fn(*rays):
        out = render_fn(*shard_batch(rays, group))
        if isinstance(out, torch.Tensor):
            return all_gather_cat(out, group)
        return type(out)(all_gather_cat(o, group) for o in out)

    return fn
