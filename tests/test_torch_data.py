"""The port's Data library (``ray_tpu_torch.data``: numpy column blocks,
the streaming executor, splits and the device prefetch) against the JAX
package's ``ray_tpu.data`` (Arrow blocks) on the same numpy inputs made
from a seed: the same pipelines give equal numpy batches. The JAX side
runs on the JAX package's cluster (``ray_cluster``), the port's on its
own, both in this process."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ray_tpu.data as jax_data
import ray_tpu_torch as rt
from ray_tpu_torch import data as port_data
from ray_tpu_torch.data.block import BlockAccessor, batch_to_block, build_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_cluster():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture()
def clusters(ray_cluster, port_cluster):
    yield


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, 100, (60, 3)).astype(np.int64),
            "y": rng.standard_normal(60)}


def _map_pipeline(pkg, inputs: dict):
    """from_numpy -> map_batches (tasks) -> map_batches (an actor pool of
    a stateful class) -> filter."""
    class Offset:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, batch):
            return {"x": batch["x"] + self.offset,
                    "s": batch["x"].sum(axis=1) * batch["y"]}

    ds = pkg.from_numpy(inputs["x"], column="x")
    ds = ds.map_batches(lambda b: {"x": b["x"] * 2,
                                   "y": b["x"][:, 0] / 7.0})
    ds = ds.map_batches(Offset, compute=pkg.ActorPoolStrategy(size=2),
                        fn_constructor_args=(5,))
    return ds.filter(lambda r: r["x"][1] % 3 != 0)


def _batches(it) -> list:
    return [{k: np.asarray(v) for k, v in b.items()} for b in it]


def _assert_batches_equal(got: list, want: list):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _rows(rows) -> list:
    """Rows as sortable tuples of plain values."""
    return sorted(tuple((k, np.asarray(v).tolist()) for k, v in
                        sorted(r.items())) for r in rows)


def test_map_filter_iter_batches_equal_the_jax_pipeline(clusters):
    inputs = _inputs(0)
    kw = dict(batch_size=7, drop_last=True)
    want = _batches(_map_pipeline(jax_data, inputs).iter_batches(**kw))
    got = _batches(_map_pipeline(port_data, inputs).iter_batches(**kw))
    _assert_batches_equal(got, want)
    assert all(len(b["x"]) == 7 for b in got)


def test_range_split_equals_the_jax_split(clusters):
    want = jax_data.range(50, parallelism=5).split(2)
    got = port_data.range(50, parallelism=5).split(2)
    assert [_rows(s.take_all()) for s in got] == \
        [_rows(s.take_all()) for s in want]
    assert sorted(r["id"] for s in got for r in s.take_all()) == \
        list(range(50))


def test_streaming_split_equals_the_jax_split(clusters):
    def consume(pkg):
        ds = pkg.range(40, parallelism=8).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        its = ds.streaming_split(2)
        return [_rows(it.iter_rows()) for it in its]

    want, got = consume(jax_data), consume(port_data)
    assert got == want
    union = sorted(got[0] + got[1])
    assert union == _rows({"id": i, "sq": i * i} for i in range(40))
    assert len(got[0]) == len(got[1]) == 20


def test_to_device_batches_on_the_cpu_equal_iter_batches(port_cluster):
    inputs = _inputs(5)
    ds = port_data.from_numpy(inputs["x"], column="x")
    want = _batches(ds.streaming_split(1)[0].iter_batches(batch_size=8,
                                                          drop_last=True))
    got = list(ds.streaming_split(1)[0].to_device_batches(batch_size=8,
                                                          device="cpu"))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])
    with pytest.raises(NotImplementedError, match="item 7"):
        next(iter(ds.streaming_split(1)[0].to_device_batches(
            batch_size=8, device="cpu", sharding=object())))


def test_block_accessor_round_trips_a_3d_tensor_column():
    from ray_tpu.data.block import BlockAccessor as JaxAccessor
    from ray_tpu.data.block import batch_to_block as jax_batch_to_block

    rng = np.random.default_rng(6)
    batch = {"img": rng.standard_normal((5, 2, 3, 4)).astype(np.float32),
             "label": np.arange(5)}
    block = batch_to_block(batch)
    acc = BlockAccessor.for_block(block)
    jacc = JaxAccessor.for_block(jax_batch_to_block(batch))
    assert acc.num_rows() == jacc.num_rows() == 5
    for got in (acc.to_numpy(), acc.to_batch("numpy")):
        for k in batch:
            np.testing.assert_array_equal(got[k], jacc.to_numpy()[k])
    rows, jrows = list(acc.iter_rows()), list(jacc.iter_rows())
    assert rows[2]["img"].shape == jrows[2]["img"].shape == (2, 3, 4)
    assert rows[2]["label"] == jrows[2]["label"] == 2
    np.testing.assert_array_equal(rows[2]["img"], jrows[2]["img"])
    rebuilt = build_block(rows)
    np.testing.assert_array_equal(rebuilt["img"], batch["img"])
    np.testing.assert_array_equal(
        BlockAccessor.for_block(acc.slice(1, 3)).to_numpy()["img"],
        batch["img"][1:3])
    for fmt in ("pandas", "pyarrow"):
        with pytest.raises(NotImplementedError, match="item 11"):
            acc.to_batch(fmt)


BLOCKER = """
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pyarrow", "pandas"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
"""

SCRIPT = """
import sys
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import data, resilience, train

rt.init(num_cpus=2)
try:
    ds = data.from_items([{"k": i % 3, "v": i} for i in range(12)],
                         parallelism=3)
    ds = ds.map_batches(lambda b: {"k": b["k"], "v": b["v"] * 2})
    out = sorted((r["k"], r["sum(v)"]) for r in
                 ds.groupby("k").sum("v").take_all())
    assert out == [(0, 36), (1, 44), (2, 52)], out
    try:
        data.read_parquet("x")
    except NotImplementedError:
        pass
    else:
        raise AssertionError("read_parquet did not raise")
    assert not any(m.split(".")[0] in ("pyarrow", "pandas", "jax",
                                       "ray_tpu", "safetensors")
                   for m in sys.modules)
finally:
    rt.shutdown()
print("ok")
"""


def test_data_runs_without_pyarrow_and_pandas(tmp_path):
    """The blocker goes in a ``sitecustomize`` on PYTHONPATH, so the
    driver and every worker it starts run without the two packages; the
    Train and resilience packages import there too, and nothing loads
    JAX, ``ray_tpu`` or safetensors."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(BLOCKER))
    script = tmp_path / "main.py"
    script.write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]


def test_train_data_and_resilience_import_no_arrow_pandas_or_safetensors():
    """The card's machine has none of these: the Train and Data libraries
    and the checkpoints keep to numpy and torch."""
    import ast
    import pathlib

    files = [f for sub in ("train", "data", "resilience")
             for f in sorted((pathlib.Path(REPO) / "ray_tpu_torch" / sub)
                             .rglob("*.py"))]
    assert len(files) >= 15
    for f in files:
        roots = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        bad = roots & {"jax", "jaxlib", "ray_tpu", "pyarrow", "pandas",
                       "safetensors", "orbax", "ml_dtypes"}
        assert not bad, f"{f} imports {sorted(bad)}"
