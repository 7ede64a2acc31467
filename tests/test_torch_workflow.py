"""Durable workflows on a port cluster (``ray_tpu_torch.workflow``), on
the CPU: ``tests/test_workflow.py``'s DAG, resume, diamond, continuation
and event cases; a step declared ``num_gpus=1`` runs in a worker that
sees the cards (its remote options survive the step wrapper); and one
DAG's storage layout (file names, ``status.json`` keys) equals the JAX
package's for the same DAG on ``ray_cluster``."""

import json
import os
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu import workflow as jax_workflow
from ray_tpu_torch import workflow


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down. One GPU is declared so the lease path runs on a
    # CPU-only host.
    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        yield
    finally:
        rt.shutdown()


def _pipeline(wf):
    def load():
        return [1, 2, 3]

    def double(xs):
        return [2 * x for x in xs]

    def total(xs):
        return sum(xs)

    return wf.step(total)(wf.step(double)(wf.step(load)()))


def test_dag_runs_and_persists_output(cluster, tmp_path):
    result = workflow.run(_pipeline(workflow), workflow_id="wf-basic",
                          storage=str(tmp_path))
    assert result == 12
    assert workflow.get_output("wf-basic", storage=str(tmp_path)) == 12
    assert workflow.get_status("wf-basic", storage=str(tmp_path)) == "SUCCESSFUL"
    assert workflow.list_all(storage=str(tmp_path)) == [("wf-basic",
                                                         "SUCCESSFUL")]


def test_resume_skips_completed_steps(cluster, tmp_path):
    marker_dir = tmp_path / "markers"
    marker_dir.mkdir()

    def effect(name):
        with open(marker_dir / name, "a") as f:
            f.write("x")
        return name

    def fragile(dep):
        if not os.path.exists(marker_dir / "fixed"):
            raise RuntimeError("transient failure")
        return dep + "-done"

    dag = workflow.step(fragile)(workflow.step(effect)("a"))
    with pytest.raises(RuntimeError, match="transient"):
        workflow.run(dag, workflow_id="wf-crash", storage=str(tmp_path))
    assert workflow.get_status("wf-crash", storage=str(tmp_path)) == "FAILED"
    assert (marker_dir / "a").stat().st_size == 1

    (marker_dir / "fixed").touch()
    assert workflow.resume("wf-crash", storage=str(tmp_path)) == "a-done"
    assert (marker_dir / "a").stat().st_size == 1  # not re-executed
    assert workflow.get_status("wf-crash", storage=str(tmp_path)) == \
        "SUCCESSFUL"


def test_diamond_shares_upstream(cluster, tmp_path):
    calls = tmp_path / "calls"

    def src():
        with open(calls, "a") as f:
            f.write("s")
        return 10

    def left(x):
        return x + 1

    def right(x):
        return x + 2

    def join(a, b):
        return a * b

    shared = workflow.step(src)()
    dag = workflow.step(join)(workflow.step(left)(shared),
                              workflow.step(right)(shared))
    assert workflow.run(dag, workflow_id="wf-diamond",
                        storage=str(tmp_path)) == 11 * 12
    assert calls.stat().st_size == 1


def test_continuation_extends_workflow(cluster, tmp_path):
    @workflow.step
    def double(x):
        return x * 2

    @workflow.step
    def decide(x):
        if x < 10:
            return workflow.continuation(double(x + 3))
        return x

    @workflow.step
    def plus_one(x):
        return x + 1

    out = workflow.run(plus_one(decide(2)), workflow_id="wf-cont",
                       storage=str(tmp_path))
    assert out == (2 + 3) * 2 + 1


def test_resume_inside_continuation_never_reruns_step_body(cluster, tmp_path):
    body_runs = tmp_path / "body_runs"
    flaky_flag = tmp_path / "fail_once"
    flaky_flag.write_text("1")

    @workflow.step
    def sub(x):
        if os.path.exists(str(flaky_flag)):
            os.unlink(str(flaky_flag))
            raise RuntimeError("simulated crash inside the continuation")
        return x * 10

    @workflow.step
    def body():
        with open(str(body_runs), "a") as f:
            f.write("x")
        return workflow.continuation(sub(4))

    with pytest.raises(Exception):
        workflow.run(body(), workflow_id="wf-cont-crash",
                     storage=str(tmp_path))
    assert workflow.resume("wf-cont-crash", storage=str(tmp_path)) == 40
    assert body_runs.stat().st_size == 1, "step body re-ran on resume"


def test_event_step_unblocks_on_trigger(cluster, tmp_path):
    @workflow.step
    def combine(payload, tag):
        return f"{payload}-{tag}"

    key = f"approval-{time.time_ns()}"
    dag = combine(workflow.wait_for_event(key), "done")
    fire = threading.Timer(1.0, workflow.trigger_event, (key, "approved"))
    fire.start()
    try:
        out = workflow.run(dag, workflow_id="wf-event", storage=str(tmp_path))
    finally:
        fire.join(timeout=30)
    assert not fire.is_alive()
    assert out == "approved-done"
    # a rerun serves the event payload from its checkpoint
    assert workflow.run(dag, workflow_id="wf-event",
                        storage=str(tmp_path)) == "approved-done"


def test_gpu_step_keeps_its_options(cluster, tmp_path):
    """A step made from ``remote(num_gpus=1)`` leases the ``GPU``: its
    worker is not pinned to ``CUDA_VISIBLE_DEVICES=""``, while a plain
    step's is."""
    @rt.remote(num_gpus=1)
    def on_card():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def on_cpu(seen):
        import os

        return seen, os.environ.get("CUDA_VISIBLE_DEVICES")

    dag = workflow.step(on_cpu)(workflow.step(on_card)())
    card, cpu = workflow.run(dag, workflow_id="wf-gpu", storage=str(tmp_path))
    assert card != "" and cpu == ""


def _layout(base, workflow_id) -> tuple:
    root = os.path.join(base, workflow_id)
    with open(os.path.join(root, "status.json")) as f:
        status = json.load(f)
    return sorted(os.listdir(root)), sorted(status), status["status"]


def test_storage_layout_equals_jax(ray_cluster, cluster, tmp_path):
    assert jax_workflow.run(_pipeline(jax_workflow), workflow_id="wf-layout",
                            storage=str(tmp_path / "jax")) == 12
    assert workflow.run(_pipeline(workflow), workflow_id="wf-layout",
                        storage=str(tmp_path / "port")) == 12
    want = _layout(tmp_path / "jax", "wf-layout")
    assert "dag.pkl" in want[0] and "step-__output__.pkl" in want[0]
    assert _layout(tmp_path / "port", "wf-layout") == want


def test_default_storage_is_the_ports():
    assert workflow.api._DEFAULT_STORAGE == os.path.expanduser(
        "~/.ray_tpu_torch_workflows")
    assert workflow.api._DEFAULT_STORAGE != jax_workflow.api._DEFAULT_STORAGE
