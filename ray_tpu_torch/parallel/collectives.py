"""Collective ops over a named mesh axis.

API-compatible surface with the reference's ``ray.util.collective``
(``collective.py:268-625`` — allreduce/allgather/reducescatter/broadcast/
send/recv). Each function takes the mesh axis name instead of a process
group, resolved against ``mesh=`` or, where that is not given, the mesh
of the innermost :func:`axis_env` (the port's counterpart of a
``shard_map`` body's axis environment). Every rank of the axis' group
calls the op. Each has a gradient where JAX's has one: an all-reduce's
is an all-reduce, an all-gather's a reduce-scatter and back, an
all-to-all's the reverse all-to-all, a permute's the inverse permute.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_ENV = threading.local()


@contextlib.contextmanager
def axis_env(mesh):
    """Name ``mesh``'s axes for the collectives called inside."""
    stack = _ENV.__dict__.setdefault("meshes", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _axis(axis: str, mesh):
    """(group, size, this rank's index) of ``axis``."""
    if mesh is None:
        stack = getattr(_ENV, "meshes", None)
        if not stack:
            raise ValueError(f"axis {axis!r} names no mesh: pass mesh= or "
                             f"call inside axis_env(mesh)")
        mesh = stack[-1]
    size = mesh.shape[mesh.mesh_dim_names.index(axis)]
    return mesh.get_group(axis), size, mesh.get_local_rank(axis)


def axis_index(axis: str, *, mesh=None) -> int:
    """This rank's position along ``axis`` (``lax.axis_index``)."""
    return _axis(axis, mesh)[2]


def _sum(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x, group, n: int, dim: int, tiled: bool):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _scatter_sum(x, group, n: int, dim: int, tiled: bool):
    """The sum over ranks of ``x``, this rank's chunk along ``dim``
    (tiled) or its index there (not tiled)."""
    chunks = x.chunk(n, dim) if tiled else x.unbind(dim)
    if len(chunks) != n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split in "
                         f"{n}")
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(out.view(-1),
                               torch.stack(chunks).contiguous().view(-1),
                               group=group)
    return out


def _all_to_all(x, group, n: int, split_dim: int, concat_dim: int):
    chunks = x.chunk(n, split_dim)
    if len(chunks) != n or x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split in {n}")
    inp = torch.stack(chunks).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), concat_dim)


def _permute(x, group, me: int, pairs):
    """Rank ``src`` sends to ``dst`` for each pair; a rank that receives
    nothing gets zeros."""
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    x = x.contiguous()
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, op):
        ctx.group, ctx.n, ctx.op = group, n, op
        if op in ("sum", "mean"):
            out = _sum(x, group)
            return out / n if op == "mean" else out
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.MIN, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op not in ("sum", "mean"):
            raise NotImplementedError(f"all_reduce op {ctx.op!r} has no "
                                      f"gradient (nor has lax.p{ctx.op})")
        g = _sum(g, ctx.group)
        return (g / ctx.n if ctx.op == "mean" else g), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, tiled):
        ctx.args = group, n, dim, tiled
        return _gather(x, group, n, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = group, n, dim
        return _scatter_sum(x, group, n, dim, True)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args, True), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = group, n, split_dim, concat_dim
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, n, concat_dim, split_dim), None, None, \
            None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, pairs):
        ctx.group, ctx.me, ctx.pairs = group, me, pairs
        return _permute(x, group, me, pairs)

    @staticmethod
    def backward(ctx, g):
        back = [(dst, src) for src, dst in ctx.pairs]
        return _permute(g, ctx.group, ctx.me, back), None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, root):
        ctx.group, ctx.me, ctx.root = group, me, root
        out = x.contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, root), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent flows to the root's input
        g = _sum(g, ctx.group)
        return (g if ctx.me == ctx.root else torch.zeros_like(g)), None, \
            None, None


def all_reduce(x, axis: str = "dp", op: str = "sum", *, mesh=None):
    """Reference: collective.py:268 (allreduce)."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")
    group, n, _ = _axis(axis, mesh)
    return _AllReduce.apply(x, group, n, op)


def all_gather(x, axis: str, *, tiled: bool = True, gather_dim: int = 0,
               mesh=None):
    """Reference: collective.py:433 (allgather)."""
    group, n, _ = _axis(axis, mesh)
    return _AllGather.apply(x, group, n, gather_dim, tiled)


def reduce_scatter(x, axis: str, *, scatter_dim: int = 0, mesh=None):
    """Reference: collective.py:482 (reducescatter)."""
    group, n, _ = _axis(axis, mesh)
    return _ReduceScatter.apply(x, group, n, scatter_dim)


def broadcast(x, axis: str, root: int = 0, *, mesh=None):
    """Reference: collective.py:383 — root's shard replicated to all."""
    group, _, me = _axis(axis, mesh)
    return _Broadcast.apply(x, group, me, root)


def all_to_all(x, axis: str, *, split_dim: int, concat_dim: int, mesh=None):
    """Ulysses-style sequence<->head reshuffle primitive."""
    group, n, _ = _axis(axis, mesh)
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


def ppermute(x, axis: str, *, shift: int = 1, mesh=None):
    """Ring shift: rank i sends to (i+shift) mod n. The building block of
    ring attention."""
    group, n, me = _axis(axis, mesh)
    return _Permute.apply(x, group, me,
                          [(i, (i + shift) % n) for i in range(n)])


def barrier(axis: str, *, mesh=None):
    """Synchronize all ranks on an axis (all-reduce of a unit scalar);
    returns the axis size."""
    group, _, _ = _axis(axis, mesh)
    device = "cpu" if dist.get_backend(group) == "gloo" else "cuda"
    return _sum(torch.ones((), dtype=torch.int32, device=device), group)


def send_recv(x, axis: str, pairs: list[tuple[int, int]], *, mesh=None):
    """Point-to-point by (src, dst) pairs of axis positions. Reference:
    collective.py:541/604 (send/recv) — both sides are one permute."""
    group, _, me = _axis(axis, mesh)
    return _Permute.apply(x, group, me, [tuple(p) for p in pairs])
