"""Autoscaler SDK: explicit capacity floors.

Reference: ``python/ray/autoscaler/sdk.py`` ``request_resources`` — ask
the autoscaler to hold capacity for the given bundles regardless of
current load (e.g. pre-scale before a burst). The request is stored in
the GCS KV and read by the reconciler each round; an empty list clears
it.

The port of ``ray_tpu/autoscaler/sdk.py``; the request lives in the
port's GCS KV.
"""

from __future__ import annotations

import json

REQUEST_KEY = "__autoscaler_resource_requests"


def request_resources(bundles: list[dict] | None = None) -> None:
    from ..core.worker import global_worker

    worker = global_worker()
    worker._gcs_call(
        "KvPut",
        {"key": REQUEST_KEY, "value": json.dumps(bundles or []).encode()},
    )


def get_requested_resources(gcs_kv_get) -> list[dict]:
    """Parse the stored floor (used by the reconciler)."""
    blob = gcs_kv_get(REQUEST_KEY)
    if not blob:
        return []
    try:
        return json.loads(blob)
    except ValueError:
        return []
