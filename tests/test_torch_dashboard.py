"""The port's dashboard: ``tests/test_dashboard.py``'s six cases over a
port cluster's state API — the state endpoints, the timeline, a 404, the
single-file UI, the ``ray_tpu_*`` framework metrics and their Prometheus
text, and the Grafana JSON — with ``/api/jobs`` listing a port job."""

import json
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def dashboard():
    rt.init(num_cpus=2)
    url = start_dashboard()
    try:
        yield url
    finally:
        stop_dashboard()
        rt.shutdown()


def test_dashboard_state_endpoints(dashboard):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    p = Pinger.options(name="dash-actor").remote()
    assert rt.get(p.ping.remote(), timeout=60) == "pong"

    nodes = _get(dashboard + "/api/nodes")
    assert nodes and any(n["state"] == "ALIVE" for n in nodes)
    actors = _get(dashboard + "/api/actors")
    assert any(a.get("name") == "dash-actor" for a in actors)
    assert _get(dashboard + "/api/cluster_resources").get("CPU", 0) > 0
    assert isinstance(_get(dashboard + "/api/tasks"), list)
    assert _get(dashboard + "/-/healthz") == "ok"

    client = JobSubmissionClient()
    jid = client.submit_job(entrypoint="echo dash-job")
    assert client.wait_until_terminal(jid, timeout=60) == JobStatus.SUCCEEDED
    jobs = _get(dashboard + "/api/jobs")
    assert any(j["submission_id"] == jid and j["status"] == "SUCCEEDED"
               for j in jobs), jobs
    rt.kill(p)


def test_dashboard_timeline_is_chrome_trace(dashboard):
    @rt.remote
    def traced():
        return 1

    assert rt.get(traced.remote(), timeout=60) == 1
    trace = _get(dashboard + "/api/timeline")
    events = trace if isinstance(trace, list) else trace.get("traceEvents", [])
    assert isinstance(events, list)


def test_dashboard_unknown_endpoint_404(dashboard):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dashboard + "/api/nope")
    assert e.value.code == 404


def test_dashboard_serves_spa(dashboard):
    with urllib.request.urlopen(dashboard + "/", timeout=30) as r:
        body = r.read().decode()
        ctype = r.headers.get("Content-Type", "")
    assert "text/html" in ctype
    assert "ray_tpu_torch dashboard" in body
    assert "/api/" in body and "overview" in body
    assert "res.GPU" in body and "TPU" not in body


def test_dashboard_framework_metrics_and_prometheus(dashboard):
    """GetMetrics synthesizes ray_tpu_* cluster gauges; /metrics renders
    the Prometheus exposition incl. histogram bucket families."""
    names = {m["name"] for m in _get(dashboard + "/api/metrics")}
    assert {"ray_tpu_nodes", "ray_tpu_resource_total",
            "ray_tpu_object_store_used_bytes",
            "ray_tpu_hbm_used_bytes"} <= names

    with urllib.request.urlopen(dashboard + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "ray_tpu_nodes{" in text

    from ray_tpu_torch.util.metrics import prometheus_text

    hist = [{
        "name": "t_ms", "type": "histogram", "tags": {"d": "x"},
        "value": 12.0, "count": 3, "buckets": [1, 2, 0],
        "boundaries": [10, 100],
    }]
    text = prometheus_text(hist)
    assert 't_ms_bucket{d="x",le="10"} 1' in text
    assert 't_ms_bucket{d="x",le="100"} 3' in text
    assert 't_ms_bucket{d="x",le="+Inf"} 3' in text
    assert 't_ms_sum{d="x"} 12.0' in text
    assert 't_ms_count{d="x"} 3' in text


def test_dashboard_grafana_dashboard_json(dashboard):
    d = _get(dashboard + "/api/grafana_dashboard")
    assert d["uid"] == "ray-tpu-default"
    assert len(d["panels"]) >= 10
    assert d["templating"]["list"][0]["name"] == "datasource"
    for p in d["panels"]:
        assert p["targets"], p["title"]
    titles = {p["title"] for p in d["panels"]}
    assert {"GPU chips in use", "GPU utilization"} <= titles
