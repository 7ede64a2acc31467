"""The port's Data exchanges (``ray_tpu_torch.data.executor``: the
map-reduce partition exchange behind groupby, shuffle, sort and join, on
numpy blocks) and zip, union and limit, against the JAX package's
``ray_tpu.data`` on the same inputs made from a seed. The JAX side runs
on the JAX package's cluster (``ray_cluster``), the port's on its own,
both in this process."""

import numpy as np
import pytest

import ray_tpu.data as jax_data
import ray_tpu_torch as rt
from ray_tpu_torch import data as port_data


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


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_groupby_aggregates_equal_the_jax_ones(clusters, agg):
    rng = np.random.default_rng(3)
    items = [{"k": int(k), "v": float(v)} for k, v in
             zip(rng.integers(0, 5, 80), rng.standard_normal(80))]

    def run(pkg):
        grouped = pkg.from_items(items, parallelism=4).groupby("k")
        rows = getattr(grouped, agg)("v").take_all()
        return sorted((r["k"], r[f"{agg}(v)"]) for r in rows)

    want, got = run(jax_data), run(port_data)
    assert [k for k, _ in got] == [k for k, _ in want] == list(range(5))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-12)


def test_random_shuffle_keeps_the_row_multiset(clusters):
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 10, 64)  # repeats: a multiset, not a set

    def run(pkg):
        ds = pkg.from_numpy(arr, column="v").repartition(4)
        return [r["v"] for r in ds.random_shuffle(seed=11).take_all()]

    want, got = run(jax_data), run(port_data)
    assert sorted(got) == sorted(want) == sorted(arr.tolist())
    assert got != arr.tolist()



@pytest.mark.parametrize("op", ["sort", "join_inner", "join_left_outer",
                                "zip", "union_limit"])
def test_sort_join_zip_and_union_equal_the_jax_ones(clusters, op):
    rng = np.random.default_rng(8)
    left = [{"id": int(i), "a": float(a)} for i, a in
            zip(rng.permutation(30), rng.standard_normal(30))]
    right = [{"id": int(i), "b": int(b)} for i, b in
             zip(rng.permutation(40)[:20], rng.integers(0, 9, 20))]

    def run(pkg):
        ds = pkg.from_items(left, parallelism=3)
        if op == "sort":
            return [r["id"] for r in ds.sort("a", descending=True).take_all()]
        other = pkg.from_items(right, parallelism=2)
        if op.startswith("join"):
            how = "inner" if op == "join_inner" else "left outer"
            rows = ds.join(other, on="id", how=how,
                           num_partitions=4).take_all()
            return sorted((r["id"], r["a"], r["b"]) for r in rows)
        if op == "zip":
            rows = ds.zip(pkg.from_items(left[::-1], parallelism=4)).take_all()
            return [(r["id"], r["a"], r["id_1"], r["a_1"]) for r in rows]
        return [r["id"] for r in ds.union(other).limit(45).take_all()]

    got, want = run(port_data), run(jax_data)
    assert got == want and len(got) >= 10
