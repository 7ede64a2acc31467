"""Multi-tenant LoRA multiplexing: tenants, quotas, fair queueing, adapters.

The reference serves many models from one replica fleet by keying each
request off a multiplexed model id (``serve/multiplex`` +
``ray.llm``'s LoRA model loader); this module is the tenancy layer that
turns that id into enforceable per-tenant policy:

- ``TenantSpec`` / ``TenancyConfig`` — declarative per-tenant weight,
  token quota, and the replica-level HBM adapter budget
  (``max_loaded_adapters``).
- ``TokenBucket`` — refill-on-demand token quota; the deficit at refusal
  time yields an HONEST ``Retry-After`` (when the bucket will actually
  cover the request), surfaced as a 429 via ``QuotaExceeded``.
- ``WeightedFairQueue`` — classic virtual-finish-time WFQ algebra used
  by the serve router under saturation: a waiter proceeds only when it
  holds the minimum virtual finish time, so tenants share admitted
  throughput in weight proportion regardless of arrival rates.
- ``AdapterPool`` — per-replica HBM-resident adapter bookkeeping: LRU
  over stack slots with a residency cap (``max_loaded_adapters`` may be
  smaller than the stack's ``max_loras``), pin counts for in-flight
  requests, and load/evict accounting for ``serve.status()``.
- ``TenantLedger`` — per-replica runtime state: tenant resolution,
  quota admission, shed/admit counters, and a windowed TTFT reservoir
  feeding per-tenant p95 rows up the controller probe path.

Everything here is plain host-side Python (no jax imports): the device
work stays in ``lora.py`` / the executor; this module only decides who
gets to use it.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field

DEFAULT_TENANT = "default"


def tenant_of(model_id: str | None) -> str:
    """Canonical tenant key for a request's resolved model id. The empty
    id (base model, no adapter) maps to the shared ``default`` tenant."""
    return model_id if model_id else DEFAULT_TENANT


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's policy row.

    ``weight`` is the WFQ share under saturation (relative, not a
    fraction); ``tokens_per_s`` is the sustained token quota (0 =
    unmetered) with ``burst_tokens`` of credit on top; ``ttft_slo_ms``
    is the tenant's TTFT objective (0 = no SLO) — breaches feed the
    ``slo_burn_frac`` burn-rate row and trigger a flight-recorder
    timeline dump for the breaching request."""

    name: str
    weight: float = 1.0
    tokens_per_s: float = 0.0
    burst_tokens: float = 0.0
    ttft_slo_ms: float = 0.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.tokens_per_s < 0 or self.burst_tokens < 0:
            raise ValueError(f"tenant {self.name!r}: quota must be >= 0")
        if self.ttft_slo_ms < 0:
            raise ValueError(f"tenant {self.name!r}: ttft_slo_ms must be >= 0")


@dataclass(frozen=True)
class TenancyConfig:
    """Deployment-level tenancy policy (rides ``init_kwargs`` so the
    controller can long-poll-publish it to routers)."""

    tenants: tuple[TenantSpec, ...] = ()
    max_loaded_adapters: int = 0   # 0 = no cap below lora max_loras

    @staticmethod
    def from_dict(d: "dict | TenancyConfig | None") -> "TenancyConfig | None":
        if d is None or isinstance(d, TenancyConfig):
            return d
        tenants = []
        for name, spec in (d.get("tenants") or {}).items():
            spec = spec or {}
            tenants.append(TenantSpec(
                name=name,
                weight=float(spec.get("weight", 1.0)),
                tokens_per_s=float(spec.get("tokens_per_s", 0.0)),
                burst_tokens=float(spec.get("burst_tokens", 0.0)),
                ttft_slo_ms=float(spec.get("ttft_slo_ms", 0.0))))
        return TenancyConfig(
            tenants=tuple(tenants),
            max_loaded_adapters=int(d.get("max_loaded_adapters", 0)))

    def spec(self, tenant: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == tenant:
                return t
        return TenantSpec(name=tenant)

    def weights(self) -> dict[str, float]:
        return {t.name: t.weight for t in self.tenants}


class QuotaExceeded(RuntimeError):
    """Tenant token quota exhausted — an HONEST 429: ``retry_after`` is
    when the bucket will actually cover the refused request, not a
    constant. Carried through the replica's streaming error envelope so
    the proxy writes the real status line + Retry-After header."""

    http_status = "429 Too Many Requests"
    reason = "quota_exhausted"

    def __init__(self, message: str, retry_after: int = 1):
        super().__init__(message)
        self.retry_after = max(1, int(retry_after))


class AdapterCapacityError(RuntimeError):
    """Every resident adapter slot is pinned by an in-flight request:
    the engine DEFERS admission (head-of-line wait) instead of failing
    the request — capacity pressure is a queueing condition, not an
    error the client should see."""


class TokenBucket:
    """Refill-on-demand token bucket. Not thread-safe on its own; the
    owning ledger serializes access."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self.level = self.burst
        self._last = time.monotonic()

    def _refill(self, now: float) -> None:
        self.level = min(self.burst, self.level + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, tokens: float) -> tuple[bool, int]:
        """(ok, retry_after_s). On refusal retry_after is the honest
        wait until the bucket covers ``tokens`` at the sustained rate."""
        now = time.monotonic()
        self._refill(now)
        if self.level >= tokens:
            self.level -= tokens
            return True, 0
        if self.rate <= 0:
            return False, 60
        deficit = min(tokens, self.burst) - self.level
        return False, max(1, min(60, math.ceil(deficit / self.rate)))

    def charge(self, tokens: float) -> None:
        """Post-hoc debit (generated tokens are only known at finish):
        may drive the level negative, pushing the next refusal out."""
        now = time.monotonic()
        self._refill(now)
        self.level -= tokens


class WeightedFairQueue:
    """Virtual-finish-time weighted fair queueing.

    ``enqueue(tenant, cost)`` stamps a virtual finish time
    ``vft = max(vclock, tenant_last_vft) + cost / weight``; the waiter
    holding the minimum vft is the only one eligible to proceed
    (``is_head``). ``complete`` advances the virtual clock. Under
    saturation this admits token throughput in weight proportion —
    a 2:1 weight split yields a 2:1 admitted-token ratio — while an
    idle tenant's unused share flows to the busy ones (the ``max`` with
    vclock forgives idle time instead of banking it)."""

    def __init__(self, weights: dict[str, float] | None = None):
        self._weights = dict(weights or {})
        self._last_vft: dict[str, float] = {}
        self._vclock = 0.0
        self._seq = 0
        self._pending: dict[int, tuple[float, str]] = {}  # ticket -> (vft, tenant)

    def set_weights(self, weights: dict[str, float]) -> None:
        self._weights = dict(weights or {})

    def weight(self, tenant: str) -> float:
        return max(1e-6, float(self._weights.get(tenant, 1.0)))

    def enqueue(self, tenant: str, cost: float = 1.0) -> int:
        start = max(self._vclock, self._last_vft.get(tenant, 0.0))
        vft = start + max(1e-9, cost) / self.weight(tenant)
        self._last_vft[tenant] = vft
        self._seq += 1
        self._pending[self._seq] = (vft, tenant)
        return self._seq

    def is_head(self, ticket: int) -> bool:
        """True when this ticket holds the minimum (vft, ticket) among
        pending waiters — the only waiter WFQ lets through."""
        if ticket not in self._pending:
            return True
        vft = self._pending[ticket][0]
        best = min((v, t) for t, (v, _) in self._pending.items())
        return (vft, ticket) <= best

    def complete(self, ticket: int) -> None:
        ent = self._pending.pop(ticket, None)
        if ent is not None:
            self._vclock = max(self._vclock, ent[0])

    def cancel(self, ticket: int) -> None:
        """Drop a waiter that was shed/timed out WITHOUT advancing the
        clock past it (its service was never rendered)."""
        ent = self._pending.pop(ticket, None)
        if ent is not None and ent[1] in self._last_vft:
            # Roll the tenant's last vft back if this was its newest
            # stamp, so the shed work doesn't penalize its next arrival.
            if self._last_vft[ent[1]] == ent[0]:
                others = [v for (v, t) in self._pending.values() if t == ent[1]]
                self._last_vft[ent[1]] = max(others) if others else self._vclock

    def pending_by_tenant(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for _v, t in self._pending.values():
            out[t] = out.get(t, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self._pending)


@dataclass
class _AdapterState:
    slot: int
    pins: int = 0
    loads: int = 0
    last_load_ms: float = 0.0


class AdapterPool:
    """HBM-resident adapter bookkeeping for one replica.

    Owns WHICH adapters are resident (LRU over ``capacity`` stack slots,
    at most ``max_resident`` of them occupied at once) and who holds
    pins; the caller owns the actual device write (begin_load /
    commit_load bracket it so a failed load rolls back cleanly).
    Thread-safe."""

    def __init__(self, capacity: int, max_resident: int = 0):
        self.capacity = int(capacity)
        self.max_resident = int(max_resident) if max_resident > 0 \
            else self.capacity
        self.max_resident = min(self.max_resident, self.capacity)
        self._lock = threading.Lock()
        self._resident: dict[str, _AdapterState] = {}   # id -> state
        self._order: list[str] = []                     # LRU, oldest first
        self._free = list(range(1, self.capacity + 1))
        self._loads = 0
        self._evictions = 0
        self._hits = 0
        self._load_ms_total = 0.0
        self._device_unloads = 0
        # Device release hook: ``on_evict(adapter_id, slot)`` fires when
        # an EXPLICIT eviction returns a slot to the free list, so the
        # owner zeroes the stack slot and the HBM is actually reclaimed
        # (LRU replacement inside ``begin_load`` skips it — the incoming
        # adapter's install overwrites the slot immediately anyway).
        self.on_evict = None

    # -- residency -------------------------------------------------------
    def lookup(self, adapter_id: str) -> int | None:
        """Slot if resident (pins it and refreshes LRU), else None."""
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is None:
                return None
            self._order.remove(adapter_id)
            self._order.append(adapter_id)
            st.pins += 1
            self._hits += 1
            return st.slot

    def begin_load(self, adapter_id: str) -> int:
        """Reserve a slot for a cold adapter (evicting an unpinned LRU
        victim if the residency cap is reached). Raises
        ``AdapterCapacityError`` when every resident adapter is pinned.
        The reservation is pinned; finish with ``commit_load`` or
        ``abort_load``."""
        with self._lock:
            if adapter_id in self._resident:
                # Lost a race with a concurrent load: behave like lookup.
                st = self._resident[adapter_id]
                self._order.remove(adapter_id)
                self._order.append(adapter_id)
                st.pins += 1
                return st.slot
            slot = self._claim_slot_locked()
            st = _AdapterState(slot=slot, pins=1)
            self._resident[adapter_id] = st
            self._order.append(adapter_id)
            return slot

    def _claim_slot_locked(self) -> int:
        if self._free and len(self._resident) < self.max_resident:
            return self._free.pop()
        for aid in self._order:                        # oldest first
            st = self._resident[aid]
            if st.pins == 0:
                self._order.remove(aid)
                del self._resident[aid]
                self._evictions += 1
                return st.slot
        raise AdapterCapacityError(
            f"all {len(self._resident)} resident adapters pinned "
            f"(cap {self.max_resident} of {self.capacity} slots); "
            "admission defers until a request finishes")

    def commit_load(self, adapter_id: str, load_ms: float = 0.0) -> None:
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is not None:
                st.loads += 1
                st.last_load_ms = load_ms
                self._loads += 1
                self._load_ms_total += load_ms

    def abort_load(self, adapter_id: str) -> None:
        """Roll back a begin_load whose device write failed."""
        with self._lock:
            st = self._resident.pop(adapter_id, None)
            if st is None:
                return
            if adapter_id in self._order:
                self._order.remove(adapter_id)
            st.pins -= 1
            if st.pins <= 0:
                self._free.append(st.slot)
            else:
                # Another request pinned mid-load; it will fail on its
                # own — still return the slot once pins drain via unpin.
                self._resident[adapter_id] = st
                self._order.append(adapter_id)

    def unpin(self, adapter_id: str) -> None:
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is not None and st.pins > 0:
                st.pins -= 1

    def unpin_slot(self, slot: int) -> None:
        with self._lock:
            for st in self._resident.values():
                if st.slot == slot and st.pins > 0:
                    st.pins -= 1
                    return

    # -- explicit eviction (idle-adapter device unload) -----------------
    def evict(self, adapter_id: str) -> int | None:
        """Evict one UNPINNED resident adapter and return its slot to
        the free list — then fire ``on_evict`` (outside the lock) so the
        device stack slot is zeroed, not left holding stale weights
        until some future load recycles it. Returns the freed slot, or
        None when the adapter is absent or pinned."""
        with self._lock:
            st = self._resident.get(adapter_id)
            if st is None or st.pins > 0:
                return None
            self._order.remove(adapter_id)
            del self._resident[adapter_id]
            self._free.append(st.slot)
            self._evictions += 1
            self._device_unloads += 1
            slot = st.slot
        if self.on_evict is not None:
            try:
                self.on_evict(adapter_id, slot)
            except Exception:
                pass
        return slot

    def evict_idle(self) -> list[tuple[str, int]]:
        """Evict EVERY unpinned resident adapter (fleet scale-to-zero:
        an idle replica hands its whole adapter stack's HBM back).
        Returns the ``(adapter_id, slot)`` pairs released."""
        with self._lock:
            victims = [aid for aid in list(self._order)
                       if self._resident[aid].pins == 0]
        out = []
        for aid in victims:
            slot = self.evict(aid)
            if slot is not None:
                out.append((aid, slot))
        return out

    # -- introspection ---------------------------------------------------
    def resident(self) -> dict[str, int]:
        """adapter_id -> slot, LRU order (oldest first)."""
        with self._lock:
            return {aid: self._resident[aid].slot for aid in self._order}

    def pinned(self) -> dict[str, int]:
        with self._lock:
            return {aid: st.pins for aid, st in self._resident.items()
                    if st.pins > 0}

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident": list(self._order),
                "resident_count": len(self._resident),
                "max_resident": self.max_resident,
                "capacity": self.capacity,
                "hits": self._hits,
                "loads": self._loads,
                "evictions": self._evictions,
                # HBM-slot accounting: slots genuinely free (zeroed or
                # never used) vs merely recyclable, and how many
                # evictions actually released device memory.
                "free_slots": len(self._free),
                "device_unloads": self._device_unloads,
                "avg_load_ms": (self._load_ms_total / self._loads
                                if self._loads else 0.0),
            }


@dataclass
class _TenantState:
    spec: TenantSpec
    bucket: TokenBucket | None = None
    admitted: int = 0
    shed: int = 0
    quota_rejects: int = 0
    tokens_in: int = 0
    tokens_out: int = 0
    ttft_ms: deque = field(default_factory=lambda: deque(maxlen=256))
    # Windowed SLO breach flags (parallel window to ttft_ms): burn
    # fraction = mean over the reservoir, so it recovers as the window
    # rolls — a burn-rate, not a lifetime counter.
    slo_window: deque = field(default_factory=lambda: deque(maxlen=256))
    slo_breaches: int = 0
    # EWMA of actual_cost / estimated_cost at retire: >1 means the
    # prompt+max_tokens heuristic UNDER-charges this tenant's WFQ share.
    cost_ratio: float = 1.0
    cost_samples: int = 0


class TenantLedger:
    """Per-replica tenant runtime: quota admission + counters + windowed
    TTFT reservoir. Thread-safe; cheap enough to sit on the request
    path."""

    def __init__(self, config: TenancyConfig | None = None):
        self.config = config or TenancyConfig()
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}

    def _state_locked(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            spec = self.config.spec(tenant)
            bucket = (TokenBucket(spec.tokens_per_s, spec.burst_tokens)
                      if spec.tokens_per_s > 0 else None)
            st = _TenantState(spec=spec, bucket=bucket)
            self._tenants[tenant] = st
        return st

    def admit(self, tenant: str, tokens: int) -> None:
        """Charge ``tokens`` (prompt + max_new worst case) against the
        tenant's quota; raises ``QuotaExceeded`` (honest 429) when the
        bucket can't cover it."""
        with self._lock:
            st = self._state_locked(tenant)
            if st.bucket is not None:
                ok, retry_after = st.bucket.try_acquire(tokens)
                if not ok:
                    st.quota_rejects += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r} token quota exhausted "
                        f"({st.spec.tokens_per_s:g} tok/s); retry in "
                        f"{retry_after}s", retry_after=retry_after)
            st.admitted += 1
            st.tokens_in += tokens

    def note_shed(self, tenant: str) -> None:
        with self._lock:
            self._state_locked(tenant).shed += 1

    def note_tokens(self, tenant: str, generated: int) -> None:
        with self._lock:
            self._state_locked(tenant).tokens_out += generated

    def note_ttft(self, tenant: str, ttft_ms: float) -> bool:
        """Record one TTFT sample; returns True when it breached the
        tenant's ``ttft_slo_ms`` (callers use that to trigger the
        flight-recorder dump for the breaching request)."""
        with self._lock:
            st = self._state_locked(tenant)
            st.ttft_ms.append(float(ttft_ms))
            slo = st.spec.ttft_slo_ms
            if slo <= 0:
                return False
            breached = ttft_ms > slo
            st.slo_window.append(1 if breached else 0)
            if breached:
                st.slo_breaches += 1
            return breached

    def slo_burn_frac(self, tenant: str) -> float:
        """Fraction of the windowed TTFT reservoir that breached the
        tenant's SLO (0.0 when no SLO configured or no samples yet)."""
        with self._lock:
            st = self._state_locked(tenant)
            if not st.slo_window:
                return 0.0
            return sum(st.slo_window) / len(st.slo_window)

    def note_actual(self, tenant: str, estimated: float, actual: float) -> None:
        """Retire-time WFQ cost correction: fold actual/estimated into
        the tenant's EWMA ratio. The router scales this tenant's future
        cost estimates by the published ratio, so tenants whose requests
        systematically overrun (or undershoot) their ``max_tokens``
        heuristic still get charged their true share."""
        if estimated <= 0:
            return
        ratio = max(0.01, min(100.0, float(actual) / float(estimated)))
        with self._lock:
            st = self._state_locked(tenant)
            if st.cost_samples == 0:
                st.cost_ratio = ratio
            else:
                st.cost_ratio = 0.8 * st.cost_ratio + 0.2 * ratio
            st.cost_samples += 1

    def quota_remaining(self, tenant: str) -> float | None:
        with self._lock:
            st = self._state_locked(tenant)
            if st.bucket is None:
                return None
            st.bucket._refill(time.monotonic())
            return max(0.0, st.bucket.level)

    def snapshot(self) -> dict:
        """Per-tenant rows for ``latency_snapshot`` / ``serve.status()``:
        counters are cumulative, p95 is over the windowed reservoir."""
        with self._lock:
            out = {}
            for name, st in self._tenants.items():
                vals = sorted(st.ttft_ms)
                p95 = vals[max(0, math.ceil(0.95 * len(vals)) - 1)] \
                    if vals else 0.0
                row = {"admitted": st.admitted, "shed": st.shed,
                       "quota_rejects": st.quota_rejects,
                       "tokens_in": st.tokens_in,
                       "tokens_out": st.tokens_out,
                       "weight": st.spec.weight,
                       "p95_ttft_ms": round(p95, 3)}
                if st.cost_samples:
                    row["cost_correction"] = round(st.cost_ratio, 4)
                if st.spec.ttft_slo_ms > 0:
                    row["ttft_slo_ms"] = st.spec.ttft_slo_ms
                    row["slo_breaches"] = st.slo_breaches
                    row["slo_burn_frac"] = round(
                        sum(st.slo_window) / len(st.slo_window), 4) \
                        if st.slo_window else 0.0
                if st.bucket is not None:
                    st.bucket._refill(time.monotonic())
                    row["quota_remaining"] = round(max(0.0, st.bucket.level), 1)
                    row["tokens_per_s"] = st.spec.tokens_per_s
                out[name] = row
            return out
