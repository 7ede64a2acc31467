"""Typed global config table with environment overrides.

Equivalent of the reference's ``RAY_CONFIG`` macro table
(``src/ray/common/ray_config_def.h``, 223 entries): every knob is a typed
entry, overridable via a ``RAY_TPU_TORCH_<name>`` environment variable or an
explicit dict (the reference passes a JSON blob as ``--raylet_config``).
Only knobs the TPU build actually consumes are defined; add entries here as
subsystems grow.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, fields
from typing import Any

# The port's own prefix: a reference cluster's ``RAY_TPU_<name>`` settings
# never reach a port process.
_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclass
class RayTpuConfig:
    # --- object store / plasma ---------------------------------------------
    # Max bytes serialized inline into the owner's in-process memory store
    # instead of plasma (reference: ``max_direct_call_object_size``).
    max_inline_object_size: int = 100 * 1024
    # Default plasma capacity as a fraction of system memory.
    object_store_memory_fraction: float = 0.3
    object_store_minimum_memory_bytes: int = 64 * 1024 * 1024
    # Chunk size for inter-node object transfer (reference: 5 MiB chunks,
    # ``object_manager.h:117``).
    object_manager_chunk_size: int = 5 * 1024 * 1024
    # Proactive spill starts when store usage exceeds this fraction
    # (reference ``object_spilling_threshold``).
    object_spilling_threshold: float = 0.8
    # Node memory watcher (reference ``src/ray/common/memory_monitor.h:52``):
    # above this fraction of node memory the newest retriable lease is killed.
    memory_usage_threshold: float = 0.95
    # 0 disables the watcher.
    memory_monitor_refresh_ms: int = 250
    # Stream worker stdout/stderr lines to the driver via the GCS log
    # channel (reference ``log_monitor.py`` + worker log redirection).
    log_to_driver: bool = True
    log_monitor_poll_ms: int = 500

    # --- scheduling ----------------------------------------------------------
    # Hybrid policy: pack onto nodes below this utilization score, then spread
    # (reference ``hybrid_scheduling_policy.cc``).
    scheduler_spread_threshold: float = 0.5
    # Max tasks dispatched to one worker lease before returning it.
    worker_lease_timeout_ms: int = 500
    max_pending_lease_requests_per_scheduling_category: int = 10
    # Keep a drained lease warm briefly before returning the worker: a
    # sync submit->get->submit loop re-pushes on the SAME lease instead of
    # paying acquire+return RPCs per task (reference: worker lease reuse).
    lease_idle_grace_ms: int = 20
    # How long a pipeline parks on a sibling's in-flight coalesced lease
    # RPC before de-coalescing and issuing its own (the stuck-leader
    # degrade: a leader wedged on a dropped reply or slow spawn must not
    # hold every pipeline hostage for its full RPC timeout). Read through
    # the chaos clock, so VirtualClock replays degrade deterministically.
    lease_coalesce_degrade_ms: float = 500.0

    # --- worker pool ---------------------------------------------------------
    num_prestart_workers: int = 2
    worker_register_timeout_s: float = 30.0
    # Idle pool shrink: a worker idle this long while its env key's pool
    # is over target is reaped (re-spawning later is a ~ms zygote fork).
    # Generous default: sub-second reaping made burst-heavy suites churn
    # kill/re-fork between back-to-back workloads. 0 disables shrink.
    idle_worker_killing_time_threshold_ms: int = 2500
    maximum_startup_concurrency: int = 4
    # Max normal-task specs pushed to a leased worker in ONE RPC: the
    # batch-submit path is RPC/handoff-bound, not execution-bound.
    task_push_batch_size: int = 16
    # Max workers ONE RequestWorkerLease may grant (owner-side lease
    # multiplexing): a deep task queue asks for several workers in one
    # round trip, and same-shape lease requests across pipelines coalesce
    # onto the in-flight RPC instead of each paying its own. Extra grants
    # are best-effort — the raylet only adds workers that are idle and
    # admissible right now. 1 = the legacy one-lease-per-RPC protocol.
    lease_grant_batch_size: int = 4
    # Fork workers from a warm pre-imported zygote process instead of
    # paying interpreter boot + imports per worker. Zygotes are
    # runtime-env-KEYED: the first worker of an env (env_vars /
    # working_dir / py_modules / pip) boots a zygote with that env baked
    # into its image, and every later worker of the same env hash forks
    # from it in milliseconds. Interpreter-level envs (conda /
    # py_executable / container / image_uri) can never fork — those
    # always cold-spawn (the PR 1 enforcement path).
    enable_worker_zygote: bool = True
    # Pre-forked idle workers kept warm PER runtime-env key (the zygote
    # pool): an actor-creation lease binds a pooled registered process
    # instead of paying fork+register inline. The default env's target is
    # max(num_prestart_workers, zygote_pool_size). 0 disables keyed
    # pooling (default-env prestart still applies).
    zygote_pool_size: int = 2
    # Max pool spawns kicked per maintenance tick per env key (refill
    # rate bound — a drained pool refills over a few ticks instead of
    # fork-storming the node).
    zygote_pool_refill_batch: int = 2
    # Distinct non-default runtime-env keys kept warm at once. Over the
    # cap the least-recently-leased key is evicted: its zygote dies and
    # its idle pooled workers are killed (env-mismatch eviction).
    zygote_pool_max_keys: int = 4
    # Concurrent in-flight spawns allowed when the env's zygote is LIVE
    # (forks are ~ms and pay no import cost — the lower
    # maximum_startup_concurrency bound exists to protect cold spawns'
    # interpreter-boot storms, and throttling a 1k-actor creation storm
    # to 4 concurrent ms-scale forks was pure queueing delay).
    zygote_max_fork_concurrency: int = 16
    # Ray Client sessions: the client pings every interval; the proxy
    # reaps sessions silent for the timeout (kills session-owned actors,
    # drops refs/streams, finishes the client job) — crash cleanup for
    # drivers that never call disconnect (ref: ray client reconnect grace).
    client_ping_interval_s: float = 5.0
    client_session_timeout_s: float = 30.0
    # Object-manager push: chunks a holder keeps in flight toward one
    # receiver (reference push_manager.h:30 sender-side flow control).
    push_manager_chunks_in_flight: int = 8
    # Pull admission: concurrent inbound object transfers per raylet;
    # excess pulls queue by class get > wait > task-arg
    # (reference pull_manager.h:51 prioritized bundles).
    pull_manager_max_concurrent: int = 4
    # Receiver-side push watchdog: abandon an in-flight inbound push when
    # no chunk lands for this long (holder died mid-stream), and cap the
    # total wall time one push may take before falling back to a pull.
    object_push_stall_timeout_s: float = 10.0
    object_push_complete_timeout_s: float = 120.0
    # GC grace for unsealed partial-receive allocations with no progress
    # (unsealed objects are neither spillable nor evictable).
    object_receive_gc_grace_s: float = 60.0
    # Per-chunk transfer RPC timeout (push and pull chunk calls).
    object_transfer_rpc_timeout_s: float = 60.0
    # Owner/object-directory control RPCs (GetObjectLocations, location
    # add/remove) — small messages, but cross-node.
    object_directory_rpc_timeout_s: float = 10.0
    # Device-release fence: how long to wait for a GPU-holding worker
    # process to exit (after SIGTERM, then SIGKILL) before re-granting the
    # GPU resource anyway. The card's memory is freed on process death.
    gpu_release_fence_timeout_s: float = 30.0

    # --- fault tolerance -----------------------------------------------------
    # Preemption drain window: seconds between a node's preemption notice
    # (GCE-style, or an injected `preempt_slice` chaos rule) and the VM
    # reclaim — the raylet drains (no new leases, task events flushed)
    # and then its workers are killed. GCE gives spot TPU VMs ~30 s;
    # tests/benches shrink it. Read through the chaos clock, so a
    # VirtualClock replays the window in milliseconds.
    preempt_grace_s: float = 10.0
    # GCE metadata-server preemption watcher: when enabled, every raylet
    # polls the instance metadata `preempted` key (flips to TRUE ~30 s
    # before a spot VM reclaim) and feeds the existing PreemptionNotice
    # drain path the moment it fires — no RPC from the control plane
    # needed. Off by default: only GCE instances have a metadata server.
    preempt_metadata_watch: bool = False
    preempt_metadata_url: str = ("http://metadata.google.internal/"
                                 "computeMetadata/v1/instance/preempted")
    preempt_metadata_poll_s: float = 1.0
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    health_check_period_ms: int = 1000
    health_check_failure_threshold: int = 5
    lineage_max_bytes: int = 1 << 30

    # --- RPC -----------------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    rpc_retry_base_delay_ms: int = 100
    rpc_retry_max_delay_ms: int = 5000
    rpc_max_retries: int = 5
    # Full-jitter exponential backoff (AWS style: sleep ~ U(0, base*2^n)).
    # Bare doubling synchronizes retry storms when many clients fail at
    # once (mass failure under chaos / a GCS blackout); jitter decorrelates
    # them. Off = the legacy deterministic delay*2 schedule.
    rpc_retry_jitter: bool = True
    # Fault-injection spec, format "Service.Method=req_prob,resp_prob"
    # (reference ``rpc_chaos.cc:34``, env RAY_testing_rpc_failure).
    # Extended clauses (chaos subsystem): "Method=nth:3,delay:50" fails
    # every 3rd call deterministically and delays the rest by 50 ms.
    testing_rpc_failure: str = ""
    # Seed for the probabilistic chaos modes (env-spec and FaultPlans).
    testing_rpc_failure_seed: int = 0xC0FFEE

    # --- chaos ---------------------------------------------------------------
    # Process clock for timeout-driven control loops (chaos/clock.py):
    # "" | "wall" | "virtual" | "virtual:RATE". Workers inherit the env
    # override, so RAY_TPU_TORCH_chaos_clock=virtual:50 puts the whole cluster
    # on accelerated virtual time.
    chaos_clock: str = ""
    # Reclaim a granted-but-never-acknowledged worker lease after this
    # long (the owner acks right after the grant reply arrives; a grant
    # whose reply was lost strands the reservation forever otherwise —
    # the ROADMAP-1c lease-timeout cascade). 0 disables reclaim.
    lease_orphan_timeout_s: float = 10.0

    # --- GCS -----------------------------------------------------------------
    gcs_pubsub_poll_timeout_s: float = 30.0
    gcs_storage_backend: str = "memory"  # "memory" | "file"
    # Store shards for the GCS control-plane tables (task events, KV,
    # actor records — the reference's store_client/ split): one lock per
    # shard so N raylets' concurrent flushes ingest in parallel instead
    # of convoying; reads stay linearizable per key. 1 = legacy single
    # lock.
    gcs_store_shards: int = 8
    # Pub/sub fan-out batching: publishes within this window share ONE
    # subscriber wake-up instead of each notifying every long-poller (1k
    # actors churning used to mean 1k wakes × N subscribers per flush).
    # 0 = notify per publish (legacy).
    gcs_pubsub_batch_window_ms: float = 2.0
    # Max messages one long-poll reply carries per channel; a backlogged
    # subscriber drains the rest on its next poll (bounds reply size and
    # serialization time under churn storms).
    gcs_pubsub_max_batch_msgs: int = 1000

    # --- task events / observability ----------------------------------------
    task_events_buffer_size: int = 10000
    task_events_flush_interval_ms: int = 1000
    # Coalesce one task's status transitions recorded within this window
    # into ONE wire event per flush (SUBMITTED/LEASED/FINISHED become a
    # single dict with a `transitions` list; the GCS replays them in
    # order, so records and lease-stage histograms are identical to the
    # unbatched path). 0 = one wire event per transition (legacy).
    task_event_coalesce_ms: int = 1000
    enable_timeline: bool = True
    # Distributed tracing: trace-context propagation through TaskSpec /
    # serve requests + span recording (observability/tracing.py).
    enable_tracing: bool = True
    # Spans retained by the GCS span store (whole traces are evicted
    # oldest-first past this cap).
    span_events_buffer_size: int = 20000

    # --- diagnostics ---------------------------------------------------------
    # Retained ErrorEvents in the GCS error-info buffer (list_errors()).
    error_info_buffer_size: int = 1000
    # Raylet/GCS debug_state_*.txt dump cadence; 0 disables periodic dumps
    # (the GetDebugState RPC always works).
    debug_state_dump_interval_s: float = 10.0
    # Lease-wedge watchdog: fire an ErrorEvent when an admission-queue
    # entry has waited this long while its resources could be granted
    # (head-of-line blocking / missed wake). 0 disables the watchdog.
    lease_wedge_threshold_s: float = 10.0
    lease_wedge_check_interval_s: float = 1.0

    # --- memory observability ------------------------------------------------
    # Record a Python creation callsite on every user-facing ObjectRef
    # (reference record_ref_creation_sites; powers `cli memory` attribution).
    record_ref_creation_sites: bool = True
    # Cadence of per-worker memory summaries on the task-event flush path.
    memory_report_interval_ms: int = 2000
    # Rows per worker summary (totals stay exact; only the table is capped).
    memory_summary_max_entries: int = 200
    # GCS leak watcher: flag a worker/raylet whose refcount table or pinned
    # bytes grew monotonically across this many consecutive reports by at
    # least the byte/ref thresholds. 0 intervals disables the watcher.
    memory_leak_check_interval_s: float = 5.0
    memory_leak_intervals: int = 4
    memory_leak_min_growth_bytes: int = 1 << 20
    memory_leak_min_growth_refs: int = 50
    # On-demand torch.profiler capture (cli profile): hard cap per request.
    profile_max_duration_s: float = 60.0

    # --- workers / executor --------------------------------------------------
    # Thread pool depth per worker (long-poll actor methods park threads).
    worker_executor_threads: int = 64
    # Owner-side temporary hold on returned nested refs until the caller
    # registers as a borrower (reference: borrowed-ref grace).
    borrow_hold_ttl_s: float = 600.0
    borrow_sweep_interval_s: float = 30.0
    # Client-side actor address resolution deadline (PENDING/RESTARTING).
    actor_resolve_timeout_s: float = 120.0

    # --- streaming generators ------------------------------------------------
    generator_report_timeout_s: float = 30.0
    generator_wait_consumed_poll_s: float = 10.0

    # --- global GC -----------------------------------------------------------
    # Min seconds between cluster-wide gc.collect broadcasts.
    global_gc_interval_s: float = 5.0

    # --- compiled graphs -----------------------------------------------------
    dag_ready_timeout_s: float = 120.0
    dag_channel_capacity: int = 1 << 20
    # Compiled LOOPS (dag/loop.py): ring depth = max iterations in flight
    # before put() backpressures, and the dag.loop.tick span sampling
    # stride (0 disables tick spans; every tick still counts in the
    # ray_tpu_dag_loop_ticks_total metric).
    dag_loop_credits: int = 8
    dag_loop_span_every: int = 64
    # Tick stall attribution (observability/loop_recorder.py): each
    # resident stage records its per-tick wait_up/compute/wait_down split
    # into a fixed-size in-process ring and flushes aggregate histograms
    # on the span cadence above. Always-on by default — the dag bench's
    # loop_obs_overhead_frac cell guards the cost at ≤ 2% of tick
    # dispatch; False is the bench's recorder-off baseline.
    dag_loop_stall_recording: bool = True
    dag_loop_stall_ring: int = 256

    # --- serve ---------------------------------------------------------------
    serve_router_assign_timeout_s: float = 60.0
    serve_stream_item_timeout_s: float = 120.0
    serve_stream_backpressure_items: int = 256
    # Prefix/session affinity routing: requests carrying a prefix-group
    # key (explicit session id, or a hash of the prompt's leading
    # serve_prefix_group_chars characters ≈ the first token blocks under
    # the byte tokenizer) stick to the replica whose engine already holds
    # their KV — unless that replica is serve_affinity_spill_margin
    # in-flight requests hotter than the coolest candidate (load-aware
    # spill: never queue-blow a hot replica just for affinity). The
    # group→replica map is bounded LRU (serve_affinity_map_size).
    serve_affinity_map_size: int = 2048
    serve_affinity_spill_margin: int = 4
    serve_prefix_group_chars: int = 256
    # KV-page migration (disaggregated serving + spill migration): when a
    # prefix-group request spills off its affine replica, the spill
    # target pulls the group's hot KV pages from the previous replica
    # instead of cold-prefilling (serve_spill_migration). Streamed
    # migrations move kv_migration_chunk_pages pages per message over a
    # credit-based TCP loop channel; an importer that cannot finish
    # within kv_migration_timeout_s registers the contiguous prefix it
    # received and cold-prefills the rest.
    serve_spill_migration: bool = True
    kv_migration_chunk_pages: int = 8
    kv_migration_timeout_s: float = 60.0
    # --- overload protection (graceful degradation under load spikes) ---
    # Default end-to-end request deadline stamped at proxy ingress when the
    # client sends neither an `x-raytpu-deadline-ms` header nor a
    # `timeout_s` body field. A request that expires while still QUEUED
    # (router wait or engine admission queue) fails fast without touching
    # the engine; one that expires mid-decode has its slot aborted and its
    # pages freed the same tick. 0 disables the default (requests without
    # an explicit deadline never expire).
    serve_default_deadline_s: float = 0.0
    # Router-level queue bound: max requests allowed to WAIT for a replica
    # slot per (process, deployment) router when every replica is at its
    # max_ongoing cap. Over the bound the request is shed with a 503 +
    # Retry-After derived from the observed per-replica service rate
    # (reference Serve's max_queued_requests ingress backpressure).
    # 0 = unbounded (legacy blocking behavior).
    serve_max_queued_requests: int = 64
    # Shed policy over the bound: "cost" prefers shedding the request with
    # the largest cold suffix — a request whose prefix group maps to a
    # live replica is cheap (its KV is cached) and may preempt an
    # expensive (cold) waiter's queue slot; "fifo" always sheds the
    # incoming request.
    serve_shed_policy: str = "cost"
    # Replica circuit breaker: a replica that times out this many
    # CONSECUTIVE handles is marked open in the router and excluded from
    # routing; after the cooldown one half-open probe request is allowed
    # through — success closes the circuit, failure re-opens it.
    # 0 disables the breaker.
    serve_circuit_breaker_failures: int = 3
    serve_circuit_breaker_cooldown_s: float = 5.0
    # Extra free-page headroom the engine keeps when admitting new slots
    # (on top of the worst-case per-request reservation admission already
    # takes): admission refuses — and counts `admission_rejects`, leaving
    # the request in the queue — while free pages are below the reserve,
    # so in-flight KV migrations/imports never race running slots.
    serve_admission_watermark_pages: int = 0

    # --- data ----------------------------------------------------------------
    data_max_in_flight_tasks: int = 8
    data_per_op_concurrency: int = 4
    data_exchange_partitions: int = 8

    def apply_env_overrides(self) -> None:
        for f in fields(self):
            env_key = _ENV_PREFIX + f.name
            if env_key in os.environ:
                raw = os.environ[env_key]
                setattr(self, f.name, _coerce(raw, f.type))

    def apply_dict(self, overrides: dict[str, Any]) -> None:
        valid = {f.name for f in fields(self)}
        for key, value in overrides.items():
            if key not in valid:
                raise ValueError(f"Unknown config key: {key}")
            setattr(self, key, value)

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, blob: str) -> "RayTpuConfig":
        cfg = cls()
        cfg.apply_dict(json.loads(blob))
        return cfg


def _coerce(raw: str, type_name: Any) -> Any:
    name = type_name if isinstance(type_name, str) else getattr(type_name, "__name__", str(type_name))
    if name == "bool":
        return raw.lower() in ("1", "true", "yes")
    if name == "int":
        return int(raw)
    if name == "float":
        return float(raw)
    return raw


_config_lock = threading.Lock()
_config: RayTpuConfig | None = None


def get_config() -> RayTpuConfig:
    global _config
    with _config_lock:
        if _config is None:
            _config = RayTpuConfig()
            _config.apply_env_overrides()
        return _config


def reset_config() -> None:
    global _config
    with _config_lock:
        _config = None
