"""The port's Grafana dashboard factory against the JAX package's: the
generated JSON is the same once ``TPU`` is mapped to ``GPU`` in the
panels' expressions and titles, and ``python -m ray_tpu_torch.grafana``
prints it."""

import json
import subprocess
import sys
from pathlib import Path

from ray_tpu.grafana import generate_dashboard as jax_dashboard
from ray_tpu_torch.grafana import generate_dashboard

REPO = Path(__file__).resolve().parents[1]


def _gpu(obj):
    """``obj`` with "TPU" mapped to "GPU" in every string."""
    if isinstance(obj, dict):
        return {k: _gpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_gpu(v) for v in obj]
    return obj.replace("TPU", "GPU") if isinstance(obj, str) else obj


def test_dashboard_equals_jax_with_tpu_mapped_to_gpu():
    port, ref = generate_dashboard(), jax_dashboard()
    assert port == _gpu(ref)
    assert "TPU" not in json.dumps(port)
    # the mapping is not vacuous: the accelerator panels name the card
    exprs = [t["expr"] for p in port["panels"] for t in p["targets"]]
    assert 'ray_tpu_resource_used{resource="GPU"}' in exprs
    assert 'ray_tpu_resource_total{resource="GPU"}' in exprs
    assert any("TPU" in json.dumps(p) for p in ref["panels"])
    assert generate_dashboard("custom")["title"] == "custom"


def test_module_prints_the_dashboard():
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.grafana"],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO, check=True).stdout
    assert json.loads(out) == generate_dashboard()
