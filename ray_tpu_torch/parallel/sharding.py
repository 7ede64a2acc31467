"""Logical-axis sharding rules.

Model code names array dimensions with *logical* axes ("batch", "embed",
"heads", ...); a rule table maps each logical axis to zero or more mesh
axes. Changing the parallelism strategy = changing the table, not the
model. A spec (one entry a tensor dimension: a mesh axis, a tuple of
them, or None) becomes DTensor placements over a ``DeviceMesh``: one
``Shard(dim)`` or ``Replicate()`` a mesh dimension.
"""

from __future__ import annotations

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
LogicalAxisRules = dict[str, object]

DEFAULT_RULES: LogicalAxisRules = {
    # activations: batch shards across hosts (dcn) then dp
    "batch": ("dcn", "dp", "fsdp"),
    "seq": "sp",
    "embed_act": None,
    # params: fsdp shards the embed dim (ZeRO-3); tp shards heads/mlp/vocab
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    # Embedding-table vocab dim: replicated. Sharding it over tp makes
    # params["embed"][tokens] a cross-shard gather; lm_head keeps
    # "vocab"→tp, whose logits product partitions well.
    "vocab_in": None,
    "layers": "pp",
    "experts": "ep",
    "expert_mlp": "tp",
    "kv_seq": "sp",
    "norm": None,
}


def spec_for(logical_axes: tuple[str | None, ...],
             rules: LogicalAxisRules) -> tuple:
    """Translate a tuple of logical axis names into a spec: a mesh axis,
    a tuple of mesh axes or None for each dimension, trailing Nones
    dropped (``jax.sharding.PartitionSpec``'s entries)."""
    mesh_axes = []
    used: set[str] = set()
    for name in logical_axes:
        axis = rules.get(name) if name else None
        # a mesh axis may appear only once in a spec; later repeats replicate
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a not in used) or None
            if isinstance(axis, tuple) and len(axis) == 1:
                axis = axis[0]
        if isinstance(axis, str) and axis in used:
            axis = None
        if axis is None:
            mesh_axes.append(None)
        else:
            for a in axis if isinstance(axis, tuple) else (axis,):
                used.add(a)
            mesh_axes.append(axis)
    while mesh_axes and mesh_axes[-1] is None:
        mesh_axes.pop()
    return tuple(mesh_axes)


def logical_sharding(mesh, logical_axes: tuple[str | None, ...],
                     rules: LogicalAxisRules | None = None) -> tuple:
    """DTensor placements (one per mesh dimension) for a tensor whose dims
    carry the given logical axes. A dimension sharded over several mesh
    axes is split major to minor in mesh order, as JAX splits it in the
    spec's order; a rule naming them in another order raises."""
    # DTensor's import costs about a second: paid by its first user only
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for dim, axes in enumerate(spec_for(tuple(logical_axes),
                                        rules or DEFAULT_RULES)):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"dim {dim} shards over {axes}, not in the "
                             f"mesh's order {names}")
        for i in order:
            placements[i] = Shard(dim)
    return tuple(placements)


def _map(tree, axes_tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, axes_tree[k], fn) for k, v in tree.items()}
    return fn(tree, axes_tree)


def shard_params(params, axes_tree, mesh, rules=None):
    """Distribute a param tree (the full tensors, on every rank) according
    to a matching tree of logical-axes tuples: a tree of DTensors whose
    local shards are this rank's."""
    from torch.distributed.tensor import distribute_tensor

    return _map(params, axes_tree, lambda t, axes: distribute_tensor(
        t, mesh, logical_sharding(mesh, axes, rules)))


def sharding_tree(axes_tree, mesh, rules=None):
    """Tree of placements from a tree of logical-axes tuples."""
    if isinstance(axes_tree, dict):
        return {k: sharding_tree(v, mesh, rules) for k, v in axes_tree.items()}
    return logical_sharding(mesh, axes_tree, rules)


def shard_constraint(x, mesh, logical_axes, rules=None):
    """``x`` laid out by logical axes: a DTensor is redistributed; a plain
    tensor is taken as replicated on every rank (differentiable both
    ways)."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = logical_sharding(mesh, tuple(logical_axes), rules)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements)


def unshard(x):
    """Gather a (possibly sharded) tensor or tree fully onto the host."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, dict):
        return {k: unshard(v) for k, v in x.items()}
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu()
