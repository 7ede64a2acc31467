"""The port's CLI (``python -m ray_tpu_torch.cli``) on a port cluster:
the CLI cases of ``tests/test_observability.py`` (list and status; the
timeline and trace smoke), ``tests/test_diagnostics.py`` (doctor),
``tests/test_memory_observability.py`` (memory and doctor) and
``tests/test_chaos.py`` (doctor naming an installed fault plan); `status`
from another process listing a pending GPU demand; `chaos run --dry-run`
printing the JAX package's bytes for the same plan and seed; and `bench`
exiting 2."""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import chaos
from ray_tpu_torch.cli import main
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.util import state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def cluster():
    info = rt.init(num_cpus=2)
    try:
        yield info["address"]
    finally:
        rt.shutdown()


def _poll(fn, timeout=30.0, interval=0.3):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    return fn()


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


def test_cli_list_and_status(capsys):
    assert main(["list", "nodes"]) == 0
    out = capsys.readouterr().out
    assert "NODE_ID" in out
    assert main(["status"]) == 0
    out = capsys.readouterr().out
    assert "alive" in out and "CPU" in out
    assert "pending demand: (none)" in out


def test_cli_trace_and_timeline_smoke(tmp_path, capsys):
    @rt.remote
    def cli_probe():
        return 1

    with tracing.span("cli-smoke-root", kind="test") as ctx:
        assert rt.get(cli_probe.remote(), timeout=60) == 1

    def _ready():
        names = {s["name"] for s in state.list_spans(trace_id=ctx.trace_id)}
        return {"cli-smoke-root", "task cli_probe"} <= names

    assert _poll(_ready), "root/task spans never flushed"

    out_path = str(tmp_path / "cli_timeline.json")
    assert main(["timeline", "-o", out_path]) == 0
    with open(out_path) as f:
        assert json.load(f)
    capsys.readouterr()

    assert main(["trace"]) == 0
    out = capsys.readouterr().out
    assert "TRACE_ID" in out and ctx.trace_id[:12] in out

    assert main(["trace", ctx.trace_id]) == 0
    out = capsys.readouterr().out
    assert "cli-smoke-root" in out and "task cli_probe" in out


def test_cli_doctor(capsys):
    assert main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "LEASE_QUEUE" in out
    assert "recent errors" in out
    assert "GCS:" in out


def test_cli_memory_and_doctor_smoke(capsys):
    assert rt.get(rt.put(1), timeout=30) == 1
    assert _poll(lambda: state.memory_summary().get("num_workers", 0) >= 1)

    assert main(["memory"]) == 0
    out = capsys.readouterr().out
    assert "workers" in out and "OBJECT_ID" in out

    assert main(["memory", "--group-by-callsite"]) == 0
    assert "CALLSITE" in capsys.readouterr().out

    assert main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "per-node lease queues" in out and "GCS:" in out

    from ray_tpu_torch.dashboard import _collect

    assert "workers" in _collect("memory")
    assert isinstance(_collect("profiles"), list)


def test_cli_doctor_reports_active_fault_plan(capsys):
    chaos.install("worker-kill", seed=9)
    try:
        assert main(["doctor"]) == 0
        out = capsys.readouterr().out
        assert "ACTIVE FAULT PLAN" in out and "worker-kill" in out
        assert "seed=9" in out
    finally:
        chaos.uninstall()
    assert main(["doctor"]) == 0
    assert "ACTIVE FAULT PLAN" not in capsys.readouterr().out


def test_cli_status_from_another_process_shows_pending_gpu_demand(cluster):
    """An operator's `status` joins through a raylet with no CPU and no
    card, and lists the GPU lease no node can take."""
    @rt.remote(num_gpus=1)
    def needs_a_card():
        return 1

    ref = needs_a_card.remote()

    def _demand():
        nodes = state.list_nodes()
        return any(d["shape"].get("GPU") for n in nodes
                   for d in n.get("pending_demand") or [])

    assert _poll(_demand), "the GPU demand never reached the GCS"
    proc = _cli("--address", cluster, "status")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "{GPU: 1} x 1" in proc.stdout, proc.stdout
    assert "GPU:" not in proc.stdout.split("pending demand:")[0]
    rt.cancel(ref, force=True)


def test_chaos_dry_run_bytes_equal_jax_cli():
    for plan, seed in (("worker-kill", 9), ("push-client-drop", 1)):
        port = _cli("chaos", "run", plan, "--seed", str(seed), "--dry-run")
        ref = subprocess.run(
            [sys.executable, "-m", "ray_tpu.cli", "chaos", "run", plan,
             "--seed", str(seed), "--dry-run"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
        assert port.stdout.encode() == ref.stdout.encode()
        assert port.stdout.strip()


def test_chaos_plans_lists_bundled_plans(capsys):
    assert main(["--json", "chaos", "plans"]) == 0
    names = {p["name"] for p in json.loads(capsys.readouterr().out)}
    assert {"worker-kill", "push-client-drop"} <= names


def test_bench_exits_2_naming_item_10():
    proc = _cli("bench", "core", "--tasks", "10")
    assert proc.returncode == 2
    assert "not ported yet" in proc.stderr and "item 10" in proc.stderr
