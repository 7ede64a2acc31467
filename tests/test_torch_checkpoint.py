"""The port's checkpoints (``ray_tpu_torch.train.checkpoint``,
``ray_tpu_torch.resilience.checkpoint``): ``torch.save`` trees written
atomically, the async manager's commit protocol held against the JAX
package's on one sequence of saves, the host snapshot, and the GCS
registration on a port cluster."""

import os
import signal
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

import ray_tpu.resilience as jax_resilience
import ray_tpu_torch as rt
from ray_tpu_torch.resilience import (AsyncCheckpointManager,
                                      latest_committed, latest_registered,
                                      list_committed, load_checkpoint,
                                      register_latest)
from ray_tpu_torch.resilience.checkpoint import COMMIT_MARKER, _snapshot
from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
                   "b": torch.randn(8, generator=g)},
        "tokens": torch.randint(0, 1 << 40, (3, 5), generator=g),
        "opt": [torch.randn(2, generator=g, dtype=torch.float64), 7],
        "step": seed,
        "name": "run",
    }


def _assert_equal_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal_trees(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        # bit for bit, NaN payloads and signed zeros included
        assert torch.equal(got.view(torch.uint8) if got.dim() else got,
                           want.view(torch.uint8) if want.dim() else want)
    else:
        assert got == want


def test_save_load_pytree_round_trips_bit_for_bit(tmp_path):
    tree = _tree(3)
    tree["params"]["w"][0, 0] = float("nan")
    tree["params"]["b"][0] = -0.0
    save_pytree(tree, str(tmp_path))
    assert os.listdir(tmp_path) == ["state.pt"]
    _assert_equal_trees(load_pytree(str(tmp_path)), tree)
    # like= puts each tensor on the dtype (and device) of its counterpart
    like = {"params": {"w": torch.zeros(4, 8), "b": torch.zeros(
        8, dtype=torch.bfloat16)}, "tokens": torch.zeros(3, 5, dtype=torch.int64),
        "opt": [torch.zeros(2, dtype=torch.float64), 0], "step": 0, "name": ""}
    got = load_pytree(str(tmp_path), like=like)
    assert got["params"]["w"].dtype == torch.float32
    assert got["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"][1:],
                       tree["params"]["w"][1:].float())
    assert got["step"] == 3


KILLED_SAVE = """
import os, signal, sys, torch
sys.path.insert(0, {repo!r})
from ray_tpu_torch.train.checkpoint import save_pytree
save_pytree({{"step": 1, "w": torch.arange(8)}}, {path!r})
os.replace = lambda *a: os.kill(os.getpid(), signal.SIGKILL)
save_pytree({{"step": 2, "w": torch.arange(8) * 2}}, {path!r})
"""


def test_kill_between_write_and_replace_keeps_the_previous_version(tmp_path):
    """A process killed after the new bytes are written and fsynced, but
    before ``os.replace``, leaves the previous version loadable; its temp
    file is never mistaken for the state. An exception there (or inside
    ``torch.save``) removes the temp file as well."""
    path = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-c", KILLED_SAVE.format(repo=REPO, path=path)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    tree = load_pytree(path)
    assert tree["step"] == 1 and torch.equal(tree["w"], torch.arange(8))
    names = sorted(os.listdir(path))
    assert names[0] == "state.pt" and len(names) == 2
    assert names[1].startswith("state.pt.tmp-")

    def dying_save(obj, f, *a, **k):
        f.write(b"PK\x03\x04half-a-zip")
        raise KeyboardInterrupt

    real = torch.save
    torch.save = dying_save
    try:
        with pytest.raises(KeyboardInterrupt):
            save_pytree({"step": 3}, path)
    finally:
        torch.save = real
    assert load_pytree(path)["step"] == 1
    assert sorted(os.listdir(path)) == names


def _run_sequence(pkg, root: str, make_tree, real_write):
    """Saves of steps 0..6 with keep-K 2 through ``pkg``'s async manager;
    the commit of step 3 dies after its payload, before its marker."""
    def write(tree, path):
        real_write(tree, path)
        if tree["step"] == 3:
            raise RuntimeError("killed before the commit marker")

    mgr = pkg.AsyncCheckpointManager(root, keep_k=2, register_with_gcs=False,
                                     write_fn=write)
    seen = []
    try:
        for step in range(7):
            mgr.save(step, make_tree(step), metrics={"loss": 1.0 / (1 + step)})
            assert mgr.wait(20)
            seen.append([s for s, _ in pkg.list_committed(root)])
            if step == 3:
                assert pkg.latest_committed(root)["step"] == 2
    finally:
        mgr.close()
    latest = pkg.latest_committed(root)
    tree, meta = pkg.load_checkpoint(latest["path"])
    debris = [d for d in os.listdir(root) if d.startswith(".tmp-")]
    return seen, dict(mgr.metrics, max_save_block_ms=0), tree, meta, debris


def test_async_commits_and_keep_k_match_the_jax_package(tmp_path):
    from ray_tpu.train.checkpoint import save_pytree as jax_save

    jax_run = _run_sequence(
        jax_resilience, str(tmp_path / "jax"),
        lambda s: {"step": s, "w": np.full(16, float(s), np.float32)},
        jax_save)
    port_run = _run_sequence(
        rt.resilience, str(tmp_path / "port"),
        lambda s: {"step": s, "w": torch.full((16,), float(s))},
        save_pytree)
    assert port_run[0] == jax_run[0]
    assert port_run[0][-1] == [5, 6] and port_run[0][3] == [1, 2]
    assert port_run[1] == jax_run[1]
    assert port_run[1]["commit_errors"] == 1
    (jtree, jmeta), (ptree, pmeta) = jax_run[2:4], port_run[2:4]
    assert ptree["step"] == jtree["step"] == 6
    np.testing.assert_array_equal(ptree["w"].numpy(), jtree["w"])
    assert {k: pmeta[k] for k in ("step", "metrics")} == \
        {k: jmeta[k] for k in ("step", "metrics")}
    assert port_run[4] == jax_run[4] == []


def test_load_checkpoint_refuses_a_commit_without_its_marker(tmp_path):
    d = tmp_path / "ckpt_00000007"
    save_pytree({"step": 7}, str(d))
    with pytest.raises(FileNotFoundError, match=COMMIT_MARKER):
        load_checkpoint(str(d))
    assert latest_committed(str(tmp_path)) is None and \
        list_committed(str(tmp_path)) == []


def test_snapshot_copies_and_never_aliases():
    src = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "bf": torch.ones(4, dtype=torch.bfloat16),
           "meta": {"steps": [1, 2]}, "n": 3}
    src["w"].requires_grad_()
    snap = _snapshot(src)
    assert snap["w"].data_ptr() != src["w"].data_ptr()
    assert snap["bf"].data_ptr() != src["bf"].data_ptr()
    assert not snap["w"].requires_grad and snap["bf"].dtype == torch.bfloat16
    with torch.no_grad():
        src["w"].add_(100)
    src["bf"].zero_()
    src["meta"]["steps"].append(3)
    assert torch.equal(snap["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(snap["bf"], torch.ones(4, dtype=torch.bfloat16))
    assert snap["meta"] == {"steps": [1, 2]} and snap["n"] == 3


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=2)
    try:
        yield
    finally:
        rt.shutdown()


def test_commits_register_on_the_port_gcs(cluster, tmp_path):
    run = f"regtest-{uuid.uuid4().hex[:6]}"
    assert latest_registered(run) is None
    mgr = AsyncCheckpointManager(str(tmp_path / "reg"), run_name=run, keep_k=2)
    try:
        mgr.save(3, {"step": 3, "w": torch.zeros(4)})
        assert mgr.wait(20)
        entry = latest_registered(run)
        assert entry["step"] == 3
        assert os.path.exists(os.path.join(entry["path"], COMMIT_MARKER))
        mgr.save(5, {"step": 5})
        assert mgr.wait(20)
        assert latest_registered(run)["step"] == 5
    finally:
        mgr.close()
    # an entry whose path lost its marker is ignored
    assert register_latest(run, str(tmp_path / "gone"), 9)
    assert latest_registered(run) is None
