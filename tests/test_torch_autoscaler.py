"""The port's autoscaler reconciler: ``tests/test_autoscaler.py``'s three
cases with a ``GPU`` node type — the launch decision for unmet demand,
scale-up from infeasible ``num_gpus=1`` tasks and idle scale-down on real
port raylets (``LocalNodeProvider`` on ``cluster_utils.Cluster``), and
the ``request_resources`` floor — a ``num_gpus=1`` actor that pends as
demand until its node is launched, and the JAX package's reconciler and
the port's driven through one scripted demand, whose launch and
terminate sequences must be equal once ``TPU`` is mapped to ``GPU``."""

import json
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu.autoscaler import Autoscaler as JaxAutoscaler
from ray_tpu.autoscaler import NodeTypeConfig as JaxNodeTypeConfig
from ray_tpu.autoscaler.node_provider import NodeLaunchError as JaxLaunchError
from ray_tpu_torch.autoscaler import (Autoscaler, LocalNodeProvider,
                                      NodeTypeConfig, request_resources)
from ray_tpu_torch.autoscaler.node_provider import NodeLaunchError
from ray_tpu_torch.autoscaler.sdk import REQUEST_KEY
from ray_tpu_torch.cluster_utils import Cluster


class _FakeProvider:
    def __init__(self, fail_types=(), error=NodeLaunchError):
        self.launched = []
        self.terminated = []
        self.fail_types = set(fail_types)
        self.error = error

    def create_node(self, node_type, resources):
        if node_type in self.fail_types:
            raise self.error("capacity", transient=True, reason="stockout")
        self.launched.append(node_type)
        return f"i-{len(self.launched)}"

    def terminate_node(self, iid):
        self.terminated.append(iid)

    def non_terminated_nodes(self):
        return {f"i-{i+1}": t for i, t in enumerate(self.launched)
                if f"i-{i+1}" not in self.terminated}

    def node_id_of(self, iid):
        return f"n-{iid}"


def test_reconcile_unit_launches_for_unmet_demand():
    """Pure decision logic: pending GPU shapes with no capacity -> launch
    the first fitting type, respecting max_workers."""
    nodes = [{
        "node_id": "a", "state": "ALIVE",
        "resources": {"available": {"CPU": 0.0}, "total": {"CPU": 1.0}},
        "pending_demand": [{"shape": {"CPU": 1.0, "GPU": 1.0}, "count": 3}],
    }]

    def gcs_call(method, payload):
        if method == "GetAllNodes":
            return {"nodes": nodes}
        if method == "ListPlacementGroups":
            return {"placement_groups": []}
        if method == "KvGet":
            return {"value": None}
        raise AssertionError(method)

    provider = _FakeProvider()
    scaler = Autoscaler(
        gcs_call, provider,
        [NodeTypeConfig("gpu-1", {"CPU": 2.0, "GPU": 1.0}, max_workers=2),
         NodeTypeConfig("gpu-8", {"CPU": 16.0, "GPU": 8.0}, max_workers=1)],
        launch_cooldown_s=0.0,
    )
    decision = scaler.reconcile_once()
    # 3 x GPU:1 demand -> two "gpu-1" (cap), then one "gpu-8" takes the rest.
    assert decision.launch == ["gpu-1", "gpu-1", "gpu-8"]
    assert provider.launched == ["gpu-1", "gpu-1", "gpu-8"]


@pytest.fixture()
def scaling_cluster():
    # A head with no card (the raylet would advertise this host's cards),
    # the driver on a node of its own with neither CPU nor card.
    c = Cluster(
        initialize_head=True,
        head_node_args={"num_cpus": 1, "resources": {"GPU": 0}},
        _system_config={"health_check_failure_threshold": 5},
    )
    rt.init(address=c.address, num_cpus=0, resources={"GPU": 0})
    provider = LocalNodeProvider(c)

    def gcs_call(method, payload):
        return c._loop.run_sync(getattr(c.gcs, f"handle_{method}")(payload))

    try:
        yield c, provider, gcs_call
    finally:
        rt.shutdown()
        c.shutdown()


def test_scale_up_runs_infeasible_gpu_tasks_then_scales_down(scaling_cluster):
    """num_gpus=1 tasks no live node can take report demand through the
    heartbeats; the reconciler launches GPU nodes, the tasks run there,
    and the nodes are terminated once idle."""
    c, provider, gcs_call = scaling_cluster
    scaler = Autoscaler(
        gcs_call, provider,
        [NodeTypeConfig("gpu", {"CPU": 2.0, "GPU": 1.0}, max_workers=2)],
        idle_timeout_s=2.0, launch_cooldown_s=0.5,
    )
    scaler.start(period_s=0.5)
    try:
        @rt.remote(num_gpus=1)
        def on_gpu_node(i):
            return i * 10

        results = rt.get([on_gpu_node.remote(i) for i in range(3)],
                         timeout=120)
        assert sorted(results) == [0, 10, 20]
        assert provider.non_terminated_nodes(), "no node was launched"
        assert set(provider.non_terminated_nodes().values()) == {"gpu"}

        deadline = time.monotonic() + 40
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.5)
        assert not provider.non_terminated_nodes(), "idle nodes were not terminated"
    finally:
        scaler.stop()


def test_request_resources_floor(scaling_cluster):
    """An explicit GPU floor launches nodes with zero load, and clearing it
    lets them scale back down."""
    c, provider, gcs_call = scaling_cluster
    scaler = Autoscaler(
        gcs_call, provider,
        [NodeTypeConfig("gpu", {"CPU": 1.0, "GPU": 1.0}, max_workers=4)],
        idle_timeout_s=1.5, launch_cooldown_s=0.2,
    )
    scaler.start(period_s=0.4)
    try:
        request_resources([{"GPU": 1.0}, {"GPU": 1.0}])
        stored = gcs_call("KvGet", {"key": REQUEST_KEY})["value"]
        assert json.loads(stored) == [{"GPU": 1.0}, {"GPU": 1.0}]
        deadline = time.monotonic() + 30
        while len(provider.non_terminated_nodes()) < 2 and time.monotonic() < deadline:
            time.sleep(0.3)
        assert len(provider.non_terminated_nodes()) >= 2

        # Floor-held nodes persist well past idle_timeout (no churn).
        held = set(provider.non_terminated_nodes())
        time.sleep(3 * 1.5)
        assert held <= set(provider.non_terminated_nodes()), "floor nodes churned"

        request_resources([])  # clear the floor
        deadline = time.monotonic() + 40
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.5)
        assert not provider.non_terminated_nodes()
    finally:
        scaler.stop()


def test_gpu_actor_pends_until_a_node_is_launched(scaling_cluster):
    """A num_gpus=1 actor no node can take is queued on a live raylet,
    whose heartbeats report it as demand; it is placed on the node the
    autoscaler launches for it, and the node goes once the actor does."""
    c, provider, gcs_call = scaling_cluster

    @rt.remote(num_gpus=1)
    class OnCard:
        def where(self):
            return rt.get_runtime_context().node_id

    actor = OnCard.remote()

    def _gpu_demand():
        return any(d["shape"].get("GPU")
                   for n in gcs_call("GetAllNodes", {})["nodes"]
                   for d in n.get("pending_demand") or [])

    deadline = time.monotonic() + 20
    while not _gpu_demand() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _gpu_demand(), "the pending actor was never reported as demand"
    assert not provider.non_terminated_nodes()

    scaler = Autoscaler(
        gcs_call, provider,
        [NodeTypeConfig("gpu", {"CPU": 1.0, "GPU": 1.0}, max_workers=1)],
        idle_timeout_s=1.0, launch_cooldown_s=0.2)
    scaler.start(period_s=0.3)
    try:
        node_id = rt.get(actor.where.remote(), timeout=120)
        (iid,) = provider.non_terminated_nodes()
        assert node_id == provider.node_id_of(iid)
        rt.kill(actor)
        deadline = time.monotonic() + 30
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.3)
        assert not provider.non_terminated_nodes()
    finally:
        scaler.stop()


# ------------------------------------------------------------ cross-package

def _script(acc: str) -> list:
    """Rounds of (head pending demand, placement groups, floor, busy
    launched instances, node types failing to launch) with the
    accelerator resource named ``acc``."""
    def s(**kw):
        return {k.replace("ACC", acc): v for k, v in kw.items()}

    return [
        # demand for three one-card shapes and a pending group
        dict(demand=[(s(CPU=1.0, ACC=1.0), 3)],
             pgs=[{"state": "PENDING", "bundles": [s(ACC=1.0)]}],
             floor=[], busy={"i-1", "i-2", "i-3"}, fail=()),
        # booted, busy, nothing pending: nothing to do
        dict(demand=[], pgs=[], floor=[], busy={"i-1", "i-2", "i-3", "i-4"},
             fail=()),
        # a CPU-only floor and a shape no type fits
        dict(demand=[(s(ACC=64.0), 1)], pgs=[], floor=[{"CPU": 8.0}],
             busy={"i-1", "i-3", "i-4"}, fail=()),
        # i-2 idle: terminated (timeout 0); the cpu floor node is held
        dict(demand=[], pgs=[], floor=[{"CPU": 8.0}],
             busy={"i-1", "i-3", "i-4"}, fail=()),
        # the one-card type stocks out: backoff, demand routes elsewhere
        dict(demand=[(s(CPU=1.0, ACC=1.0), 2)], pgs=[], floor=[],
             busy={"i-1", "i-3", "i-4"}, fail=("acc-1",)),
        # everything idle, floor cleared: all terminated
        dict(demand=[], pgs=[], floor=[], busy=set(), fail=()),
    ]


def _drive(Scaler, NodeType, error, acc: str) -> list:
    types = [NodeType("acc-1", {"CPU": 4.0, acc: 1.0}, max_workers=3),
             NodeType("acc-8", {"CPU": 32.0, acc: 8.0}, max_workers=2),
             NodeType("cpu", {"CPU": 8.0}, max_workers=2)]
    provider = _FakeProvider(error=error)
    state = {}

    def gcs_call(method, payload):
        rnd = state["round"]
        if method == "GetAllNodes":
            nodes = [{"node_id": "head", "state": "ALIVE",
                      "resources": {"total": {"CPU": 1.0},
                                    "available": {"CPU": 0.0}},
                      "pending_demand": [{"shape": dict(sh), "count": n}
                                         for sh, n in rnd["demand"]]}]
            res = {t.name: t.resources for t in types}
            for iid, t in provider.non_terminated_nodes().items():
                total = dict(res[t])
                avail = ({k: 0.0 for k in total} if iid in rnd["busy"]
                         else dict(total))
                nodes.append({"node_id": f"n-{iid}", "state": "ALIVE",
                              "resources": {"total": total,
                                            "available": avail},
                              "pending_demand": []})
            return {"nodes": nodes}
        if method == "ListPlacementGroups":
            return {"placement_groups": rnd["pgs"]}
        if method == "KvGet":
            return {"value": json.dumps(rnd["floor"]).encode()
                    if rnd["floor"] else None}
        raise AssertionError(method)

    scaler = Scaler(gcs_call, provider, types, idle_timeout_s=0.0,
                    launch_cooldown_s=0.0, launch_backoff_base_s=300.0)
    events = []
    for i, rnd in enumerate(_script(acc)):
        state["round"] = rnd
        provider.fail_types = set(rnd["fail"])
        before = len(provider.terminated)
        decision = scaler.reconcile_once()
        events += [(i, "launch", t) for t in decision.launch]
        events += [(i, "terminate", iid)
                   for iid in provider.terminated[before:]]
    return events


def test_decisions_equal_jax_autoscaler_with_tpu_mapped_to_gpu():
    jax_events = _drive(JaxAutoscaler, JaxNodeTypeConfig, JaxLaunchError,
                        "TPU")
    port_events = _drive(Autoscaler, NodeTypeConfig, NodeLaunchError, "GPU")
    assert port_events == jax_events
    kinds = {e[1] for e in port_events}
    assert kinds == {"launch", "terminate"}, port_events
