"""The port's multi-node harness (``ray_tpu_torch.cluster_utils.Cluster``)
and its chaos runner (``ray_tpu_torch.chaos.run_plan``), on the CPU: on a
two-node port cluster a task lands on the added node and the node's
removal shows in ``nodes()``; ``run_plan`` over ``default_workload``
gives a report with the JAX package's keys and schedule digest for the
same plan and seed (the JAX side on ``ray_cluster``), and its verifier
is green."""

import pytest

import ray_tpu_torch as rt
from ray_tpu import chaos as jax_chaos
from ray_tpu_torch.cluster_utils import Cluster

PLAN, SEED = "push-client-drop", 1


@pytest.fixture(scope="module")
def cluster():
    """The driver on a 0-CPU node, so every task runs on a peer node."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2},
                _system_config={"health_check_failure_threshold": 3})
    rt.init(address=c.address, num_cpus=0)
    try:
        yield c
    finally:
        rt.shutdown()
        c.shutdown()


def _node_of_task():
    @rt.remote(resources={"extra": 1})
    def where():
        return rt.get_runtime_context().node_id

    return where


def _states() -> dict:
    return {n["node_id"]: n["state"] for n in rt.nodes()}


def test_task_lands_on_added_node_and_removal_is_seen(cluster):
    added = cluster.add_node(num_cpus=1, resources={"extra": 1})
    node_id = added.node_id.hex()
    assert _states()[node_id] == "ALIVE"
    assert rt.get(_node_of_task().remote(), timeout=90) == node_id
    cluster.remove_node(added)
    cluster.wait_for_node_death(added, timeout=60)
    assert _states()[node_id] == "DEAD"
    assert cluster.head_node.node_id.hex() in {
        n for n, s in _states().items() if s == "ALIVE"}


def test_run_plan_report_equals_jax(ray_cluster, cluster):
    from ray_tpu_torch import chaos

    # ``chaos`` is a lazy attribute of the package, as in ``ray_tpu``
    assert rt.chaos is chaos
    got = chaos.run_plan(PLAN, seed=SEED, verify_timeout_s=60)
    want = jax_chaos.run_plan(PLAN, seed=SEED, verify=False)
    assert got["verify"]["ok"], got["verify"]["violations"]
    assert sorted(got) == sorted([*want, "verify"])
    assert got["schedule_digest"] == want["schedule_digest"]
    assert (got["plan"], got["seed"]) == (want["plan"], want["seed"])
    assert got["workload"] == want["workload"] == {
        "tasks": 10, "ok": 10, "failures": 0}
    jax_verifier = jax_chaos.RecoveryVerifier(timeout_s=5)
    assert sorted(got["verify"]["checks"]) == sorted(
        jax_verifier.verify(jax_verifier.snapshot_baseline()).checks)
    assert chaos.active_plan() is None  # uninstalled
