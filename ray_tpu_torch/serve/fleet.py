"""Fleet policy: the pure decision half of the always-warm serving
fleet (ROADMAP item 5).

The controller's reconcile loop stays readable by keeping every fleet
decision a pure function over probe-derived state: how many standbys a
deployment wants, what the scheduled-capacity floor is right now,
whether the recent TTFT trend projects past the SLO (predictive
upscale), and whether an idle deployment should fall to standby or to
host-RAM-only. The controller (``serve/controller.py``) owns the FSM —
STANDBY replicas hold weights in host RAM with a warm compile cache and
promote via ``device_put`` (``llm/weights.py``) — this module only
answers "what should the fleet look like".

Scheduled capacity entries are dicts with absolute unix times::

    {"start": <unix>, "end": <unix>, "min_replicas": N}

so operators can pre-arm capacity for a known spike (a product launch,
a batch window) and promotion fires before the first request, not after
the p95 breach.
"""

from __future__ import annotations


def _cfg_get(auto, key: str, default=None):
    """Read a knob off an AutoscalingConfig object OR the plain dict the
    controller stores (serve/api.py serializes the dataclass)."""
    if auto is None:
        return default
    if isinstance(auto, dict):
        val = auto.get(key, default)
    else:
        val = getattr(auto, key, default)
    return default if val is None else val


def scheduled_floor(entries, now: float) -> int:
    """The largest ``min_replicas`` of every scheduled-capacity window
    covering ``now`` (0 when none do). Malformed entries are skipped —
    a bad schedule must never wedge the reconcile loop."""
    floor = 0
    for ent in entries or ():
        try:
            if float(ent["start"]) <= now < float(ent["end"]):
                floor = max(floor, int(ent["min_replicas"]))
        except (KeyError, TypeError, ValueError):
            continue
    return floor


def slope_projection(samples, horizon_s: float) -> float | None:
    """Project a metric ``horizon_s`` ahead by least-squares slope over
    ``samples`` = [(ts, value), ...]. Returns None with fewer than 3
    points or a degenerate time spread — prediction needs a trend, not
    two noisy dots."""
    pts = [(float(t), float(v)) for t, v in (samples or ())
           if v is not None]
    if len(pts) < 3:
        return None
    n = len(pts)
    t0 = pts[0][0]
    xs = [t - t0 for t, _ in pts]
    ys = [v for _, v in pts]
    span = xs[-1] - xs[0]
    if span <= 1e-6:
        return None
    mx = sum(xs) / n
    my = sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den <= 1e-9:
        return None
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
    return ys[-1] + slope * float(horizon_s)


def desired_standby(auto) -> int:
    """How many STANDBY replicas a deployment keeps warm. With
    scale-to-zero enabled a deployment always affords at least one
    standby slot (else the first request pays a full cold start, which
    defeats the feature)."""
    if auto is None:
        return 0
    n = int(_cfg_get(auto, "standby_replicas", 0) or 0)
    if _cfg_get(auto, "scale_to_zero_idle_s"):
        n = max(n, 1)
    return max(0, n)


def should_scale_to_zero(idle_s: float | None, auto) -> bool:
    """True once a deployment's replicas have been request-idle past
    ``scale_to_zero_idle_s``. ``idle_s`` is None until every replica
    has reported an idle age (an unknown replica might be busy)."""
    if auto is None or idle_s is None:
        return False
    thresh = _cfg_get(auto, "scale_to_zero_idle_s")
    if not thresh or float(thresh) <= 0:
        return False
    return float(idle_s) >= float(thresh)


def fold_fleet_rows(rows) -> dict | None:
    """Fold per-replica ``serve_fleet`` probe rows into the deployment
    view the controller's decision phase consumes: the fleet is only as
    idle as its BUSIEST replica (min idle age), and weight residency
    counts report how much of the fleet could demote at all."""
    idle = None
    unknown = False
    residency_capable = 0
    host_resident = 0
    n = 0
    for row in rows or ():
        if not isinstance(row, dict):
            continue
        n += 1
        age = row.get("idle_s")
        if age is None:
            # One replica with unknown idleness poisons the fold: we
            # must not scale-to-zero under it.
            unknown = True
        else:
            idle = float(age) if idle is None else min(idle, float(age))
        if row.get("residency_capable"):
            residency_capable += 1
        if row.get("weights_on_host"):
            host_resident += 1
    if n == 0:
        return None
    return {"idle_s": None if unknown else idle, "replicas": n,
            "residency_capable": residency_capable,
            "host_resident": host_resident}
