"""Parity of the port's parallel layer (``ray_tpu_torch.parallel``,
``ops.ring_attention``, ``ops.ulysses_attention`` and ``moe_block``'s
``ep`` path) with the JAX package's, on the CPU.

The pure logic (``MeshConfig.resolve``, ``mesh_shape_for``, ``spec_for``,
``logical_sharding``) runs here. Everything that needs a process group
runs in one spawn of 4 gloo CPU processes (``tests/_torch_parallel_
worker.py``, which imports no JAX), each holding one rank's shard; the
JAX side runs the same numpy inputs through ``shard_map`` on a 4-device
CPU mesh (``tests/conftest.py`` gives 8), with the per-device outputs
concatenated on dim 0 and each device's cotangent its chunk of one
seeded array. So the loss differentiated on both sides is the sum over
ranks of each rank's product with its own cotangent.

Tolerances, relative to the largest magnitude of the reference: the
collectives and ``shard_params`` move values without arithmetic or add
exactly (bit-equal, or 1e-6 where a sum's order differs); ring and
Ulysses attention 1e-5 forward and 1e-4 gradients (float32 sums in
another order); the ``ep`` MoE 1e-6 forward and 1e-5 gradients.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as W
from ray_tpu.models import moe as jax_moe
from ray_tpu.models.llama import PRESETS as JAX_PRESETS
from ray_tpu.models.llama import param_axes as jax_param_axes
from ray_tpu.ops.ring_attention import ring_attention as jax_ring
from ray_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from ray_tpu.parallel import collectives as jc
from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from ray_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from ray_tpu.parallel.sharding import shard_params as jax_shard_params
from ray_tpu.parallel.sharding import spec_for as jax_spec_for
from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, mesh_shape_for
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.sharding import logical_sharding, spec_for
from _torch_parity import numpy_params

N = W.WORLD
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_parallel_worker.py")
SPAWN_TIMEOUT_S = 120


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: relative error {err} > {tol}"


# ------------------------------------------------------------- pure logic
@pytest.mark.parametrize("cfg,n", [
    (dict(dp=-1), 8), (dict(fsdp=2, tp=-1), 8), (dict(dcn=2, dp=2, tp=2), 8),
    (dict(pp=2, ep=-1), 6), (dict(sp=4), 4)])
def test_mesh_config_resolves_as_jax(cfg, n):
    assert dataclasses_equal(MeshConfig(**cfg).resolve(n),
                             JaxMeshConfig(**cfg).resolve(n))
    assert dataclasses_equal(mesh_shape_for(n, MeshConfig(**cfg)),
                             jax_mesh_shape_for(n, JaxMeshConfig(**cfg)))


def dataclasses_equal(a, b) -> bool:
    return a.sizes() == b.sizes()


@pytest.mark.parametrize("cfg,n", [(dict(dp=-1, tp=-1), 8), (dict(dp=3), 8),
                                   (dict(tp=3, dp=-1), 8)])
def test_mesh_config_errors_as_jax(cfg, n):
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**cfg).resolve(n)
    with pytest.raises(ValueError) as got:
        MeshConfig(**cfg).resolve(n)
    assert str(got.value) == str(want.value)
    assert mesh_shape_for(4) == MeshConfig(dp=4)


def test_spec_for_matches_jax():
    cases = [("batch", "seq", "embed_act"), ("embed", "heads", "head_dim"),
             ("batch", "batch", "seq"), ("layers", "experts", "embed",
                                         "expert_mlp"),
             ("vocab_in", "embed"), ("embed", "vocab"), (None, "kv_seq"),
             ("batch", "embed")]
    for axes in cases:
        assert spec_for(axes, DEFAULT_RULES) == tuple(
            jax_spec_for(axes, JAX_RULES)), axes
    rules = {"a": ("dp", "tp"), "b": "tp", "c": ("tp", "dp")}
    for axes in [("a", "b"), ("b", "a"), ("a", "c"), ("c", "a", "b")]:
        assert spec_for(axes, rules) == tuple(jax_spec_for(axes, rules)), axes
    assert DEFAULT_RULES == JAX_RULES


class _Mesh:
    mesh_dim_names = AXIS_ORDER


def test_logical_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    got = logical_sharding(_Mesh(), ("batch", "seq", "embed_act"))
    want = {"dcn": Shard(0), "dp": Shard(0), "fsdp": Shard(0), "sp": Shard(1)}
    assert got == tuple(want.get(a, Replicate()) for a in AXIS_ORDER)
    with pytest.raises(ValueError, match="mesh's order"):
        logical_sharding(_Mesh(), ("x",), {"x": ("tp", "dp")})


# ------------------------------------------------------- the gloo spawn
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of the 4 gloo workers."""
    out = tmp_path_factory.mktemp("gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(WORKER))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(N),
                               str(port), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(N)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(N)]


def test_workers_import_no_jax(ranks):
    assert all(r["imported_jax"].size == 0 for r in ranks), \
        [list(r["imported_jax"]) for r in ranks]


def _stacked(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=0)


@functools.lru_cache(maxsize=None)
def _jax_mesh(**sizes):
    return jax_create_mesh(JaxMeshConfig(**sizes), devices=jax.devices()[:N])


def _jax_collective(name):
    op, kw, shape, has_grad = W.COLLECTIVES[name]
    x = jnp.asarray(W.normal(f"{name}/x", (N * shape[0],) + shape[1:]))
    body = functools.partial(getattr(jc, op), axis="dp", **kw)
    fn = shard_map(body, mesh=_jax_mesh(dp=N), in_specs=P("dp"),
                   out_specs=P("dp"), check_vma=False)
    if not has_grad:
        return jax.jit(fn)(x), None
    ct = jnp.asarray(W.normal(f"{name}/ct",
                              W.collective_global_out_shape(name)))
    (_, out), dx = jax.jit(jax.value_and_grad(
        lambda x: (jnp.sum(fn(x) * ct), fn(x)), has_aux=True))(x)
    return out, dx


@pytest.mark.parametrize("name", sorted(W.COLLECTIVES))
def test_collective_matches_jax(ranks, name):
    want, want_dx = _jax_collective(name)
    np.testing.assert_allclose(_stacked(ranks, f"{name}/out"),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    if want_dx is not None:
        np.testing.assert_allclose(_stacked(ranks, f"{name}/dx"),
                                   np.asarray(want_dx), rtol=1e-6, atol=1e-6)
    else:
        # lax.pmax / pmin have no gradient, nor have the port's
        assert all(r["max_grad_raises"] for r in ranks)


def test_barrier_mesh_and_local_mesh(ranks):
    want = shard_map(lambda: jc.barrier("dp"), mesh=_jax_mesh(dp=N),
                     in_specs=(), out_specs=P(), check_vma=False)()
    assert [float(r["barrier/out"]) for r in ranks] == [float(want)] * N
    assert all(tuple(r["mesh/shape"]) == _jax_mesh(dp=N).devices.shape
               for r in ranks)
    assert [int(r["local/single_host_size"]) for r in ranks] == [N] * N
    # ranks 0, 1 on one host, 2, 3 on another: a mesh of two each
    assert [int(r["local/two_host_size"]) for r in ranks] == [2] * N
    assert [float(r["local/two_host_sum"][0]) for r in ranks] == [1, 1, 5, 5]


def _jax_device_shards(arr, mesh):
    """Each mesh device's shard of ``arr``, in the mesh's device order."""
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_device[d] for d in mesh.devices.reshape(-1)]


@pytest.mark.parametrize("mesh_name,preset", [("fsdp2_tp2", "debug"),
                                              ("ep2_tp2", "llama-moe-debug")])
def test_shard_params_local_shards_match_jax(ranks, mesh_name, preset):
    mesh = _jax_mesh(**W.SHARD_MESHES[mesh_name])
    tree = numpy_params(JAX_PRESETS[preset], seed=7)
    sharded = jax_shard_params(jax.tree.map(jnp.asarray, tree),
                               jax_param_axes(JAX_PRESETS[preset]), mesh)
    for path, arr in jax.tree_util.tree_leaves_with_path(sharded):
        key = "/".join(p.key for p in path)
        for r, shard in enumerate(_jax_device_shards(arr, mesh)):
            np.testing.assert_array_equal(
                ranks[r][f"shard/{mesh_name}/{key}"], shard, err_msg=key)
    assert all(r[f"shard/{mesh_name}/unshard_equal"] for r in ranks)


def test_shard_constraint_batch_over_two_axes_matches_jax(ranks):
    mesh = _jax_mesh(**W.SHARD_MESHES["dp2_fsdp2"])
    from ray_tpu.parallel.sharding import logical_sharding as jax_ls

    act = W.normal("act", (8, 12, 6))
    arr = jax.device_put(jnp.asarray(act), jax_ls(
        mesh, ("batch", "seq", "embed_act")))
    for r, shard in enumerate(_jax_device_shards(arr, mesh)):
        np.testing.assert_array_equal(ranks[r]["shard/dp2_fsdp2/act"], shard)
        np.testing.assert_array_equal(
            ranks[r]["shard/dp2_fsdp2/act_unshard"], act)


def _jax_attention(fn, hq, hkv):
    inp = {k: jnp.asarray(a) for k, a in W.attn_inputs(hq, hkv).items()}
    spec = P(None, None, "sp", None)
    sm = shard_map(functools.partial(fn, axis="sp", causal=True),
                   mesh=_jax_mesh(sp=N), in_specs=(spec,) * 3,
                   out_specs=spec, check_vma=False)

    def loss(q, k, v):
        out = sm(q, k, v)
        return jnp.sum(out * inp["ct"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(inp["q"], inp["k"], inp["v"])
    return out, dict(zip(("dq", "dk", "dv"), grads))


def _by_seq(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=2)


@pytest.mark.parametrize("impl,heads", [
    ("ring", h) for h in W.RING_HEADS] + [
    ("ulysses", h) for h in W.ULYSSES_HEADS])
def test_sequence_parallel_attention_matches_jax(ranks, impl, heads):
    hq, hkv = heads
    fn = jax_ring if impl == "ring" else jax_ulysses
    out, grads = _jax_attention(fn, hq, hkv)
    tag = f"{impl}{hq}_{hkv}"
    _close(_by_seq(ranks, f"{tag}/out"), out, 1e-5, f"{tag} out")
    for g, want in grads.items():
        _close(_by_seq(ranks, f"{tag}/{g}"), want, 1e-4, f"{tag} {g}")


def test_ulysses_head_checks_raise_as_jax(ranks):
    for hq, hkv in ((6, 2), (8, 3)):
        with pytest.raises(ValueError) as want:
            shard_map(functools.partial(jax_ulysses, axis="sp"),
                      mesh=_jax_mesh(sp=N), in_specs=(P(),) * 3,
                      out_specs=P(), check_vma=False)(
                jnp.zeros((1, hq, 4, 16)), jnp.zeros((1, hkv, 4, 16)),
                jnp.zeros((1, hkv, 4, 16)))
        assert all(str(r[f"ulysses_raises/{hq}_{hkv}"]) == str(want.value)
                   for r in ranks)


def test_moe_ep_matches_jax_shard_map(ranks):
    """``moe_block`` with ``ep_axis="ep"`` over 4 ranks, 2 experts each,
    capacity factor 1.0 (tokens dropped): output, aux and every gradient
    against JAX's ``shard_map`` with experts on P("ep") and the tokens
    and router replicated. A replicated input's gradient is the sum of
    the ranks' (JAX's transpose of a replicated input), and that is the
    single-device gradient of the same summed loss."""
    t = W.moe_tree()
    kw = dict(top_k=W.MOE["top_k"], capacity_factor=1.0,
              n_experts_global=W.MOE["x"])

    def body(x, router, wg, wu, wd):
        out, aux = jax_moe.moe_block(
            x, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd},
            ep_axis="ep", **kw)
        return out[None], aux[None]

    sm = shard_map(body, mesh=_jax_mesh(ep=N),
                   in_specs=(P(), P(), P("ep"), P("ep"), P("ep")),
                   out_specs=(P("ep"), P("ep")), check_vma=False)
    args = [jnp.asarray(t[k]) for k in ("x", "router", "w_gate", "w_up",
                                        "w_down")]

    def loss(*a):
        out, aux = sm(*a)
        return (jnp.sum(out * t["ct"]) + W.MOE["aux_weight"] * jnp.sum(aux),
                (out, aux))

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True))(*args)
    for r in range(N):
        _close(ranks[r]["moe/out"], out[r], 1e-6, f"rank {r} out")
        _close(ranks[r]["moe/aux"], aux[r], 1e-6, f"rank {r} aux")
    _close(sum(r["moe/dx"] for r in ranks), grads[0], 1e-5, "dx")
    _close(sum(r["moe/drouter"] for r in ranks), grads[1], 1e-5, "drouter")
    for i, n in enumerate(("w_gate", "w_up", "w_down"), start=2):
        _close(np.concatenate([r[f"moe/d{n}"] for r in ranks]), grads[i],
               1e-5, f"d{n}")

    # the same loss on one device: every rank's cotangent summed
    full = {k: jnp.asarray(t[k]) for k in ("router", "w_gate", "w_up",
                                           "w_down")}

    def single(x, p):
        out, aux = jax_moe.moe_block(x, p, **kw)
        return (jnp.sum(out * t["ct"].sum(0))
                + N * W.MOE["aux_weight"] * aux)

    sx, sp = jax.jit(jax.grad(single, argnums=(0, 1)))(jnp.asarray(t["x"]),
                                                       full)
    _close(grads[0], sx, 1e-5, "shard_map dx against one device")
    _close(grads[1], sp["router"], 1e-5, "drouter against one device")
    _close(grads[2], sp["w_gate"], 1e-5, "dw_gate against one device")
