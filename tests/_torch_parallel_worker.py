"""One rank of the port's parallel layer on gloo CPU processes, for
``tests/test_torch_parallel.py``. Imports torch, numpy and the port only
(never JAX):

    python tests/_torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Every rank builds its meshes, runs every case on the same seeded numpy
inputs (this module's ``normal``, ``attn_inputs`` and ``moe_tree``, which
the test calls too) and writes what it got to
``OUT_DIR/rank{RANK}.npz``: each output and input gradient under
``"{case}/out"``, ``"{case}/d{input}"``.
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

WORLD = 4
COLLECTIVES = {
    # name: (op, kwargs, per-rank input shape, has a gradient)
    "all_reduce_sum": ("all_reduce", {"op": "sum"}, (4, 6), True),
    "all_reduce_mean": ("all_reduce", {"op": "mean"}, (4, 6), True),
    "all_reduce_max": ("all_reduce", {"op": "max"}, (4, 6), False),
    "all_reduce_min": ("all_reduce", {"op": "min"}, (4, 6), False),
    "all_gather_d0": ("all_gather", {"gather_dim": 0}, (4, 6), True),
    "all_gather_d1": ("all_gather", {"gather_dim": 1}, (4, 6), True),
    "all_gather_untiled": ("all_gather", {"tiled": False, "gather_dim": 1},
                           (4, 6), True),
    "reduce_scatter_d0": ("reduce_scatter", {"scatter_dim": 0}, (8, 6), True),
    "reduce_scatter_d1": ("reduce_scatter", {"scatter_dim": 1}, (4, 8), True),
    "broadcast_root1": ("broadcast", {"root": 1}, (4, 6), True),
    "all_to_all_0_1": ("all_to_all", {"split_dim": 0, "concat_dim": 1},
                       (4, 6), True),
    "all_to_all_1_0": ("all_to_all", {"split_dim": 1, "concat_dim": 0},
                       (4, 8), True),
    "ppermute_1": ("ppermute", {"shift": 1}, (4, 6), True),
    "ppermute_3": ("ppermute", {"shift": 3}, (4, 6), True),
    "send_recv": ("send_recv", {"pairs": [(0, 2), (2, 1), (3, 3)]}, (4, 6),
                  True),
}
# (Hq, Hkv) of the attention cases: GQA 4:1 (Hkv < sp for Ulysses) and 1:1;
# Ulysses also 4:1 with Hkv = sp.
RING_HEADS = ((8, 2), (8, 8))
ULYSSES_HEADS = ((8, 2), (8, 8), (16, 4))
ATTN_B, ATTN_S, ATTN_D = 2, 32, 16
MOE = dict(b=2, s=16, e=32, m=48, x=8, top_k=2, aux_weight=0.5)
SHARD_MESHES = {"fsdp2_tp2": dict(fsdp=2, tp=2), "ep2_tp2": dict(ep=2, tp=2),
                "dp2_fsdp2": dict(dp=2, fsdp=2)}


def rng_for(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def normal(name: str, shape, scale: float = 1.0) -> np.ndarray:
    return (rng_for(name).standard_normal(shape) * scale).astype(np.float32)


def collective_global_out_shape(name: str) -> tuple:
    """The shape of the per-rank outputs concatenated on dim 0."""
    op, kw, shape, _ = COLLECTIVES[name]
    n = WORLD
    if op == "all_gather":
        d = kw["gather_dim"]
        local = list(shape)
        if kw.get("tiled", True):
            local[d] *= n
        else:
            local.insert(d, n)
        shape = tuple(local)
    elif op == "reduce_scatter":
        local = list(shape)
        local[kw["scatter_dim"]] //= n
        shape = tuple(local)
    elif op == "all_to_all":
        local = list(shape)
        local[kw["split_dim"]] //= n
        local[kw["concat_dim"]] *= n
        shape = tuple(local)
    return (n * shape[0],) + tuple(shape[1:])


def moe_tree() -> dict:
    e, m, x = MOE["e"], MOE["m"], MOE["x"]
    return {"x": normal("moe/x", (MOE["b"], MOE["s"], e)),
            "router": normal("moe/router", (e, x), e ** -0.5),
            "w_gate": normal("moe/w_gate", (x, e, m), e ** -0.5),
            "w_up": normal("moe/w_up", (x, e, m), e ** -0.5),
            "w_down": normal("moe/w_down", (x, m, e), m ** -0.5),
            # one cotangent a rank: the per-rank outputs stacked
            "ct": normal("moe/ct", (WORLD, MOE["b"], MOE["s"], e))}


def attn_inputs(hq: int, hkv: int) -> dict:
    b, s, d = ATTN_B, ATTN_S, ATTN_D
    tag = f"attn{hq}_{hkv}"
    return {"q": normal(f"{tag}/q", (b, hq, s, d)),
            "k": normal(f"{tag}/k", (b, hkv, s, d)),
            "v": normal(f"{tag}/v", (b, hkv, s, d)),
            "ct": normal(f"{tag}/ct", (b, hq, s, d))}


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    import socket

    import torch

    from ray_tpu_torch.models.moe import moe_block
    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import (MeshConfig, collectives, create_mesh,
                                        local_mesh, shard_constraint,
                                        shard_params, unshard)
    from ray_tpu_torch.parallel.distributed import initialize_process

    torch.set_num_threads(1)
    assert initialize_process(f"127.0.0.1:{port}", world, rank,
                              device="cpu") == world
    got = {}

    def put(key, t):
        got[key] = t.detach().float().numpy() if isinstance(
            t, torch.Tensor) else np.asarray(t)

    # ------------------------------------------------------ collectives
    mesh = create_mesh(MeshConfig(dp=-1), device="cpu")
    got["mesh/shape"] = np.asarray(mesh.shape)
    for name, (op, kw, shape, has_grad) in COLLECTIVES.items():
        x = torch.from_numpy(normal(f"{name}/x", (world * shape[0],)
                                    + shape[1:])).chunk(world)[rank]
        x = x.clone().requires_grad_(has_grad)
        with collectives.axis_env(mesh):
            out = getattr(collectives, op)(x, "dp", **kw)
        put(f"{name}/out", out)
        if has_grad:
            ct = torch.from_numpy(normal(
                f"{name}/ct", collective_global_out_shape(name))).chunk(
                world)[rank]
            (out * ct).sum().backward()
            put(f"{name}/dx", x.grad)
    put("barrier/out", collectives.barrier("dp", mesh=mesh))
    try:
        x = torch.ones(2, requires_grad=True)
        collectives.all_reduce(x, "dp", op="max", mesh=mesh).sum().backward()
        got["max_grad_raises"] = np.asarray(False)
    except NotImplementedError:
        got["max_grad_raises"] = np.asarray(True)

    # ------------------------------------------------------- shard_params
    from ray_tpu_torch.models.llama import PRESETS, param_axes

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_parity import numpy_params

    for mname, sizes in SHARD_MESHES.items():
        smesh = create_mesh(MeshConfig(**sizes), device="cpu")
        if mname == "dp2_fsdp2":
            act = torch.from_numpy(normal("act", (8, 12, 6)))
            axes = ("batch", "seq", "embed_act")
            local = shard_constraint(act, smesh, axes).to_local()
            put(f"shard/{mname}/act", local)
            put(f"shard/{mname}/act_unshard",
                unshard(shard_constraint(act, smesh, axes)))
            continue
        preset = "debug" if mname == "fsdp2_tp2" else "llama-moe-debug"
        tree = numpy_params(PRESETS[preset], seed=7)
        params = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
                      if isinstance(v, dict) else torch.from_numpy(v))
                  for k, v in tree.items()}
        sharded = shard_params(params, param_axes(PRESETS[preset]), smesh)
        for k, v in sharded.items():
            for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
                put(f"shard/{mname}/{k}" + (f"/{n}" if n else ""),
                    t.to_local())
        full = unshard(sharded)
        got[f"shard/{mname}/unshard_equal"] = np.asarray(all(
            torch.equal(full["layers"][n], params["layers"][n])
            for n in params["layers"]) and torch.equal(full["embed"],
                                                       params["embed"]))

    # --------------------------------------------------- ring and Ulysses
    sp_mesh = create_mesh(MeshConfig(sp=-1), device="cpu")
    for fn_name, fn, heads in (("ring", ring_attention, RING_HEADS),
                               ("ulysses", ulysses_attention, ULYSSES_HEADS)):
        for hq, hkv in heads:
            inp = attn_inputs(hq, hkv)
            local = {k: torch.from_numpy(a).chunk(world, dim=2)[rank].clone()
                     for k, a in inp.items()}
            q, k, v = (local[n].requires_grad_() for n in "qkv")
            out = fn(q, k, v, axis="sp", causal=True, mesh=sp_mesh)
            (out * local["ct"]).sum().backward()
            tag = f"{fn_name}{hq}_{hkv}"
            put(f"{tag}/out", out)
            for n, t in (("dq", q), ("dk", k), ("dv", v)):
                put(f"{tag}/{n}", t.grad)
    for hq, hkv in ((6, 2), (8, 3)):
        try:
            t = torch.zeros(1, hq, 4, 16)
            ulysses_attention(t, torch.zeros(1, hkv, 4, 16),
                              torch.zeros(1, hkv, 4, 16), mesh=sp_mesh)
            got[f"ulysses_raises/{hq}_{hkv}"] = np.asarray("")
        except ValueError as e:
            got[f"ulysses_raises/{hq}_{hkv}"] = np.asarray(str(e))

    # ------------------------------------------------------- MoE over ep
    ep_mesh = create_mesh(MeshConfig(ep=-1), device="cpu")
    tree = moe_tree()
    per = MOE["x"] // world
    x = torch.from_numpy(tree["x"]).requires_grad_()
    p = {"router": torch.from_numpy(tree["router"]).requires_grad_()}
    for n in ("w_gate", "w_up", "w_down"):
        p[n] = torch.from_numpy(tree[n][rank * per:(rank + 1) * per]
                                ).clone().requires_grad_()
    out, aux = moe_block(x, p, top_k=MOE["top_k"], capacity_factor=1.0,
                         ep_axis="ep", n_experts_global=MOE["x"],
                         mesh=ep_mesh)
    ((out * torch.from_numpy(tree["ct"][rank])).sum()
     + MOE["aux_weight"] * aux).backward()
    put("moe/out", out)
    put("moe/aux", aux)
    put("moe/dx", x.grad)
    for n, t in p.items():
        put(f"moe/d{n}", t.grad)

    # -------------------------------------------------------- local mesh
    lm = local_mesh(MeshConfig(dp=-1), device="cpu")
    got["local/single_host_size"] = np.asarray(lm.size())
    socket.gethostname = lambda: "host-a" if rank < 2 else "host-b"
    lm = local_mesh(MeshConfig(dp=-1), device="cpu")
    got["local/two_host_size"] = np.asarray(lm.size())
    got["local/two_host_sum"] = collectives.all_reduce(
        torch.tensor([float(rank)]), "dp", mesh=lm).numpy()

    got["imported_jax"] = np.asarray(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")), str)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    collectives.barrier("dp", mesh=mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
