"""The port's runtime (``ray_tpu_torch.core``): tasks, actors, the object
store, GPU leases and the worker environment, on one small cluster.

The runtime is the JAX package's own code, copied; these tests check the
places where the port differs: the accelerator pin (a CPU worker sees
``CUDA_VISIBLE_DEVICES=""``, a ``GPU`` lease unsets it and its worker
starts cold, never forked from a zygote), the vendored ``cloudpickle`` and
``msgpack`` (the runtime runs where neither, nor ``grpc``, can be
imported), and workers that import neither JAX nor ``ray_tpu``. The
cluster declares one ``GPU`` so the lease path runs on a CPU-only host.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core.status import RayTaskError

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        yield
    finally:
        rt.shutdown()


def test_task_actor_and_objects(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

    assert rt.get(add.remote(1, 2), timeout=60) == 3
    c = Counter.remote(10)
    assert rt.get([c.inc.remote(), c.inc.remote(5)], timeout=60) == [11, 16]

    arr = np.arange(300_000, dtype=np.float32).reshape(300, 1000)
    ten = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ref_arr, ref_ten = rt.put(arr), rt.put(ten)
    np.testing.assert_array_equal(rt.get(ref_arr, timeout=60), arr)
    assert torch.equal(rt.get(ref_ten, timeout=60), ten)
    # objects passed by reference to a task, and a tensor made remotely
    assert rt.get(add.remote(ref_ten, ref_ten), timeout=60).equal(ten * 2)
    np.testing.assert_array_equal(
        rt.get(add.remote(ref_arr, 1.0), timeout=60), arr + 1.0)

    ready, pending = rt.wait([add.remote(2, 2), add.remote(3, 3)],
                             num_returns=2, timeout=60)
    assert sorted(rt.get(ready, timeout=60)) == [4, 6] and not pending


def test_named_actor_and_kill(cluster):
    @rt.remote
    class Box:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    b = Box.options(name="box").remote()
    rt.get(b.set.remote("x"), timeout=60)
    assert rt.get(rt.get_actor("box").get.remote(), timeout=60) == "x"
    rt.kill(b)
    with pytest.raises(RayTaskError):
        rt.get(b.get.remote(), timeout=60)


def test_gpu_lease_unpins_the_card_and_starts_cold(cluster):
    @rt.remote
    def probe():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getppid()

    assert rt.cluster_resources().get("GPU") == 1.0
    cpu_visible, _ = rt.get(probe.remote(), timeout=60)
    assert cpu_visible == ""
    gpu_visible, parent = rt.get(probe.options(num_gpus=1).remote(),
                                 timeout=120)
    assert gpu_visible != ""
    # the raylet (a thread of this process) started it itself: no zygote
    assert parent == os.getpid()


def test_workers_load_no_jax_and_no_ray_tpu(cluster):
    @rt.remote
    def loaded():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu",
                                             "cloudpickle", "msgpack"))

    assert rt.get(loaded.remote(), timeout=60) == []


def test_worker_main_import_leaves_cuda_uninitialized():
    code = ("import sys, ray_tpu_torch.core.worker_main\n"
            "assert 'torch' not in sys.modules, 'worker_main loads torch'\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


BLOCKER = """
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cloudpickle", "msgpack", "grpc"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
"""

SCRIPT = """
import ray_tpu_torch as rt

def square(x):
    return x * x

class Acc:
    def __init__(self):
        self.total = 0

    def add(self, x):
        self.total += x
        return self.total

rt.init(num_cpus=2)
try:
    assert rt.get(rt.remote(square).remote(7), timeout=60) == 49
    acc = rt.remote(Acc).remote()
    rt.get(acc.add.remote(2), timeout=60)
    assert rt.get(acc.add.remote(3), timeout=60) == 5
    import sys
    assert not any(m.split(".")[0] in ("cloudpickle", "msgpack", "grpc")
                   for m in sys.modules)
finally:
    rt.shutdown()
print("ok")
"""


def test_runtime_runs_without_cloudpickle_msgpack_and_grpc(tmp_path):
    """The blocker goes in a ``sitecustomize`` on PYTHONPATH, so the
    driver and every worker it starts run without the three packages."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(BLOCKER))
    script = tmp_path / "main.py"
    script.write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]


def test_port_imports_no_installed_cloudpickle_or_msgpack():
    """Outside ``_vendor/``, the port reaches both only through its
    vendored copies (``from .._vendor import ...``)."""
    files = [f for f in (REPO / "ray_tpu_torch").rglob("*.py")
             if "_vendor" not in f.parts]
    assert len(files) > 50
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names
                   if n.split(".")[0] in ("cloudpickle", "msgpack")]
            assert not bad, f"{f.relative_to(REPO)} imports {bad}"
