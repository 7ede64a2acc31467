"""LLM serving deployment: OpenAI-compatible API over the paged engine.

Equivalent of the reference's ``LLMServer`` + OpenAI router
(``python/ray/llm/_internal/serve/deployments/llm/llm_server.py:415``,
``.../routers/router.py:173``): one engine per replica, concurrent
HTTP/handle requests feed the shared continuous-batching loop, and
``/v1/completions`` + ``/v1/chat/completions`` (with ``"stream": true``
SSE token streaming) ride the Serve streaming request path. Scale-out
happens at the Serve layer (num_replicas), exactly as the reference
scales vLLM engine replicas.

The port of ``ray_tpu/llm/serving.py`` for one host. Each replica's
engine runs on the card (``device=None``) or where ``device`` says. The
prefill and decode pools (``serve_disaggregation="prefill_decode"``),
spill migration between replicas, the fleet's weight broadcast and its
promotion ladder (stream, host copy, cold re-init from the seed) are
ported. Not ported yet, and raising ``NotImplementedError``: an engine
spanning hosts (``num_hosts`` > 1, ``shard_resources``) and tensor or
pipeline parallelism (ROADMAP queue A item 7).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict

import torch

from .engine import InferenceEngine, Request
from .tokenizer import ByteTokenizer

# Request-level serving metrics (lazily created so importing llm doesn't
# start the metrics flusher). serve_ttft_ms is the measurement ROADMAP
# item 2 was missing: arrival → first sampled token, tagged with the
# serve deployment hosting the engine (falls back to the model id when
# the engine runs outside serve).
_metrics_lock = threading.Lock()
_metrics: dict = {}


def _llm_metrics() -> dict:
    with _metrics_lock:
        if not _metrics:
            from ..util.metrics import Gauge, Histogram

            _metrics["ttft"] = Histogram(
                "serve_ttft_ms",
                "Time from request arrival to first generated token",
                tag_keys=("deployment", "tenant"))
            _metrics["prefix_hit_rate"] = Gauge(
                "serve_prefix_cache_hit_rate",
                "Fraction of cacheable prompt pages served from the "
                "engine's prefix cache (0-1, since engine start)",
                tag_keys=("deployment",))
            _metrics["slo_burn"] = Gauge(
                "tenant_slo_burn_frac",
                "Fraction of the tenant's windowed TTFT samples that "
                "breached its ttft_slo_ms objective (0-1; 0 when no SLO "
                "is configured)",
                tag_keys=("deployment", "tenant"))
        return _metrics


def _deployment_tag(fallback: str) -> str:
    try:
        from ..serve.replica import get_replica_context

        rc = get_replica_context()
        if rc and rc.get("deployment"):
            return rc["deployment"]
    except Exception:
        pass
    return fallback


def _observe_ttft(req: Request, deployment: str, engine=None,
                  tenant: str = "default", ledger=None) -> None:
    if req.first_token_at is None:
        return
    ttft_ms = 1000.0 * (req.first_token_at - req.arrived_at)
    _llm_metrics()["ttft"].observe(
        ttft_ms, tags={"deployment": deployment, "tenant": tenant})
    if ledger is not None:
        breached = ledger.note_ttft(tenant, ttft_ms)
        _llm_metrics()["slo_burn"].set(
            ledger.slo_burn_frac(tenant),
            tags={"deployment": deployment, "tenant": tenant})
        if breached and engine is not None:
            # SLO breach: dump the request's flight-recorder timeline
            # (at most once per request) so the slow path is replayable
            # via `cli trace --request`.
            try:
                engine.dump_timeline(req, "ttft_slo")
            except Exception:
                pass
    if engine is not None:
        _llm_metrics()["prefix_hit_rate"].set(
            engine.prefix_cache_hit_rate, tags={"deployment": deployment})


class LLMDeployment:
    """User-facing deployment class: wrap with ``serve.deployment`` (see
    ``build_llm_app``). Methods run on replica executor threads; one
    background thread drives the engine so requests batch continuously."""

    # Thread-local handoff marker: _import_migration stamps the KV token
    # count here so the request object created later ON THE SAME THREAD
    # gets an EV_MIGRATE flight-recorder event.
    _migrate_tls = threading.local()

    def __init__(
        self,
        preset: str = "debug-128",
        *,
        model_id: str | None = None,
        max_slots: int = 8,
        max_len: int = 256,
        page_size: int = 16,
        prefill_chunk_size: int = 64,
        decode_steps_per_dispatch: int = 8,
        tensor_parallel: int = 1,
        pipeline_parallel: int = 1,
        num_hosts: int = 1,
        shard_resources: dict | None = None,
        shard_runtime_env: dict | None = None,
        topology: str | None = None,
        seed: int = 0,
        request_timeout_s: float = 300.0,
        lora_config: dict | None = None,
        attention_impl: str = "auto",
        prefill_token_budget: int | None = None,
        max_prefill_seqs_per_step: int = 2,
        decode_starvation_limit: int = 8,
        use_compiled_loop: bool | None = None,
        role: str = "unified",
        decode_handle=None,
        host_kv_cache_pages: int = 0,
        max_queued_requests: int = 0,
        admission_watermark_pages: int | None = None,
        speculation_config=None,
        tenancy_config: dict | None = None,
        device=None,
    ):
        from .tenancy import TenancyConfig, TenantLedger

        if num_hosts > 1 or shard_resources is not None:
            raise NotImplementedError(
                "an engine spanning hosts (num_hosts > 1, shard_resources) "
                "is not ported yet (ROADMAP queue A item 7: llm/multihost.py)")
        if tensor_parallel > 1 or pipeline_parallel > 1:
            raise NotImplementedError(
                "tensor_parallel / pipeline_parallel > 1 is not ported yet "
                "(ROADMAP queue A item 7: the parallel layers)")
        # Multi-tenant policy: per-tenant quotas/weights + the replica's
        # HBM adapter residency cap. The same dict rides init_kwargs so
        # the controller publishes the WEIGHTS to routers via long poll;
        # this replica enforces the QUOTAS and reports per-tenant rows.
        tcfg = TenancyConfig.from_dict(tenancy_config) or TenancyConfig()
        self.tenancy = TenantLedger(tcfg)
        lora = None
        if lora_config is not None:
            # Reference: LLMConfig.lora_config + dynamic_lora_loading_path
            # (configs/server_models.py:141,236). Requests whose `model`
            # differs from the base model_id load that adapter from
            # `<dynamic_lora_loading_path>/<model>.npz` into the device
            # stack and decode with it (multi-adapter batching).
            from .lora import LoRAServingConfig

            lc = dict(lora_config)
            # Tenancy's HBM residency cap applies to the adapter LRU
            # unless the lora config pins its own.
            if tcfg.max_loaded_adapters and "max_loaded_adapters" not in lc:
                lc["max_loaded_adapters"] = tcfg.max_loaded_adapters
            lora = LoRAServingConfig(**lc)
        self.engine = InferenceEngine(
            preset, max_slots=max_slots, max_len=max_len, page_size=page_size,
            prefill_chunk_size=prefill_chunk_size,
            decode_steps_per_dispatch=decode_steps_per_dispatch,
            seed=seed, lora_config=lora,
            attention_impl=attention_impl,
            prefill_token_budget=prefill_token_budget,
            max_prefill_seqs_per_step=max_prefill_seqs_per_step,
            decode_starvation_limit=decode_starvation_limit,
            host_kv_cache_pages=host_kv_cache_pages,
            max_queued_requests=max_queued_requests,
            admission_watermark_pages=admission_watermark_pages,
            speculation_config=speculation_config,
            device=device,
        )
        # Disaggregated serving (DistServe-style prefill/decode split):
        # a "prefill"-role replica chunk-prefills prompts locally, ships
        # the KV pages to a decode replica over a migration stream, and
        # relays the decode replica's token stream; "decode" replicas
        # additionally accept migrated handoffs. "unified" (default) is
        # the classic one-pool deployment.
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        self._role = role
        self._decode_handle = decode_handle
        if role == "prefill" and decode_handle is None:
            raise ValueError("role='prefill' needs a decode_handle")
        self.model_id = model_id or (preset if isinstance(preset, str) else "custom")
        self.tokenizer = ByteTokenizer()
        if self.tokenizer.vocab_size > self.engine.config.vocab_size:
            raise ValueError(
                f"model vocab {self.engine.config.vocab_size} is smaller than "
                f"tokenizer vocab {self.tokenizer.vocab_size}; pick a preset "
                f"with vocab_size >= {self.tokenizer.vocab_size}"
            )
        self.request_timeout_s = request_timeout_s
        # Prefix-group residency: which affinity groups this replica's
        # engine holds KV for, and how often their requests actually hit
        # the prefix cache — reported to the controller through the
        # replica's latency_snapshot probe (serve_prefix_residency row).
        self._residency_lock = threading.Lock()
        self._resident_groups: "OrderedDict[str, int]" = OrderedDict()
        self._residency = {"requests": 0, "cache_hits": 0}
        # Completion waiters (blocking path) and per-request token queues
        # (streaming path), both fed by the engine loop.
        self._events: dict[str, threading.Event] = {}
        self._token_queues: dict[str, queue.Queue] = {}
        self._counter = 0
        self._lock = threading.Lock()
        # Spill-migration and weight-broadcast exporters opened FOR remote
        # pullers (reaped as their streams drain — see _track_spill_source).
        self._spill_sources: list = []
        # Always-warm fleet: request-idle clock (scale-to-zero input)
        # and the seed that reproduces this deployment's weights for the
        # promotion ladder's last-resort cold re-init.
        self._last_request_ts = time.time()
        self._seed = seed
        self._running = True
        self._loop_thread = threading.Thread(target=self._engine_loop, daemon=True)
        self._loop_thread.start()

    def _engine_loop(self) -> None:
        while self._running:
            if not self.engine.has_work:
                time.sleep(0.002)
                continue
            for event in self.engine.step():
                q = self._token_queues.get(event["request_id"])
                if q is not None:
                    q.put(event)
                if event["done"]:
                    done = self._events.pop(event["request_id"], None)
                    if done is not None:
                        done.set()

    def close(self) -> None:
        """Stop the engine loop (for in-process reuse — tests, notebooks)."""
        self._running = False
        if self._loop_thread.is_alive():
            self._loop_thread.join(timeout=5)

    def _next_rid(self) -> str:
        with self._lock:
            self._counter += 1
            # Every request path mints an rid, so this is the one choke
            # point the fleet idle clock needs.
            self._last_request_ts = time.time()
            return f"req-{self._counter}-{uuid.uuid4().hex[:8]}"

    def _adapter_for(self, model: str | None) -> str | None:
        """OpenAI `model` field -> adapter id (None = base model)."""
        if not model or model == self.model_id:
            return None
        return model

    def _tenant_for(self, model: str | None) -> str:
        """Tenant key for one request: the ``model`` body field, else
        the proxy-resolved multiplexed model id riding the replica
        thread-local, else the shared default tenant."""
        from ..serve.multiplex import get_multiplexed_model_id
        from .tenancy import tenant_of

        return tenant_of(model or get_multiplexed_model_id())

    def _note_residency(self, group: str, req: Request) -> None:
        """Record that this replica now holds (or refreshed) KV for the
        request's prefix group, and whether the request actually hit the
        engine's prefix cache (the replica-local affinity outcome)."""
        if not group:
            return
        with self._residency_lock:
            self._resident_groups[group] = \
                self._resident_groups.get(group, 0) + 1
            self._resident_groups.move_to_end(group)
            while len(self._resident_groups) > 512:
                self._resident_groups.popitem(last=False)
            self._residency["requests"] += 1
            if req.cached_prefix_tokens > 0:
                self._residency["cache_hits"] += 1

    def prefix_residency(self) -> dict:
        """Per-replica prefix-group residency (picked up by the replica
        actor's ``latency_snapshot`` probe → controller app status)."""
        with self._residency_lock:
            return {"groups": len(self._resident_groups),
                    "requests": self._residency["requests"],
                    "cache_hits": self._residency["cache_hits"]}

    @staticmethod
    def _group_of(prompt: str, session_id: str | None) -> str:
        from ..serve.router import prefix_group_key

        return prefix_group_key(session_id=str(session_id or ""),
                                text=prompt)

    @staticmethod
    def _effective_deadline(body: dict | None = None) -> float | None:
        """The request's absolute wall-clock deadline: the proxy-stamped
        value riding the replica thread-local, tightened by a
        ``timeout_s`` body field when the request arrived by handle
        (no proxy hop to stamp it)."""
        from ..serve.router import get_request_deadline

        deadline = get_request_deadline()
        t = (body or {}).get("timeout_s")
        if t is not None:
            try:
                local = time.time() + max(0.0, float(t))
                deadline = local if deadline is None else min(deadline, local)
            except (TypeError, ValueError):
                pass
        return deadline

    # ------------------------------------------------------ blocking path
    def generate(self, prompt: str, max_new_tokens: int = 16,
                 temperature: float = 0.0, model: str | None = None,
                 session_id: str | None = None,
                 deadline: float | None = None) -> dict:
        """Blocking completion; many calls run concurrently on replica
        threads and share the engine's decode batch. ``model`` other than
        the base model id selects a LoRA adapter. ``deadline`` (absolute
        wall clock; defaults to the proxy-stamped request deadline)
        bounds the request end to end — expiry in the engine queue fails
        fast, expiry mid-decode aborts the slot."""
        self._maybe_spill_migrate(prompt, model)
        if deadline is None:
            deadline = self._effective_deadline()
        ids = self.tokenizer.encode(prompt)
        rid = self._next_rid()
        tenant = self._tenant_for(model)
        # Token quota, charged worst case (prompt + max_new) up front:
        # QuotaExceeded propagates with its own http_status/retry_after,
        # so the proxy answers an honest 429 + Retry-After.
        self.tenancy.admit(tenant, len(ids) + max_new_tokens)
        req = Request(rid, ids, max_new_tokens, temperature,
                      eos_id=self.tokenizer.eos_id,
                      model=self._adapter_for(model),
                      deadline=deadline)
        self._take_migrate_mark(req)
        done = threading.Event()
        self._events[rid] = done  # before add: the engine may finish fast
        try:
            self.engine.add_request(req)
        except ValueError:
            self._events.pop(rid, None)
            raise
        except Exception:
            self._events.pop(rid, None)
            raise  # QueueFullError: the proxy answers 503 + Retry-After
        timeout = self.request_timeout_s
        if deadline is not None:
            # The engine sweeps expired deadlines each tick; the extra
            # slack only covers the tick boundary.
            timeout = max(0.05, min(timeout, deadline - time.time() + 1.0))
        if not done.wait(timeout=timeout):
            if req.done and req.finish_reason:
                finish = req.finish_reason  # engine settled it (deadline)
            else:
                self.engine.cancel(rid)
                finish = "timeout"
            self._events.pop(rid, None)
        else:
            finish = req.finish_reason
        _observe_ttft(req, _deployment_tag(self.model_id), self.engine,
                      tenant=tenant, ledger=self.tenancy)
        self.tenancy.note_tokens(tenant, len(req.generated))
        # Retire-time WFQ cost correction: the admission estimate charged
        # prompt + max_new worst case; fold the ACTUAL token count into
        # the tenant's EWMA ratio (published to routers via tenancy
        # long-poll) so future estimates converge on reality.
        self.tenancy.note_actual(tenant, len(ids) + max_new_tokens,
                                 len(ids) + len(req.generated))
        self._note_residency(self._group_of(prompt, session_id), req)
        return {
            "request_id": rid,
            "text": self.tokenizer.decode(req.generated),
            "tokens": list(req.generated),
            "finish_reason": finish,
            "num_generated": len(req.generated),
        }

    def _take_migrate_mark(self, req: Request) -> None:
        """Give ``req`` the EV_MIGRATE event that ``_import_migration``
        left on this thread, and clear the mark. Both the blocking and the
        streamed completion take it, so a streamed handoff never leaves a
        mark for a later request on the same thread."""
        migrated = getattr(self._migrate_tls, "tokens", None)
        if migrated is not None:
            from ..observability import loop_recorder

            req.timeline.add(loop_recorder.EV_MIGRATE, migrated)
            self._migrate_tls.tokens = None

    # ----------------------------------------------------- streaming path
    def _admit_streaming(self, req: Request,
                         tenant: str = "default") -> queue.Queue:
        """Register the token queue and admit ``req``. Split from
        ``_stream_tokens`` so admission — and its QueueFullError /
        QuotaExceeded shed — happens BEFORE the SSE response head is
        yielded: the proxy can then still answer a clean 503/429 +
        Retry-After status line."""
        self.tenancy.admit(tenant, len(req.prompt) + req.max_new_tokens)
        q: queue.Queue = queue.Queue()
        self._token_queues[req.request_id] = q
        try:
            self.engine.add_request(req)
        except Exception:
            self._token_queues.pop(req.request_id, None)
            raise
        return q

    def _stream_tokens(self, req: Request, group: str = "",
                       q: queue.Queue | None = None,
                       tenant: str = "default"):
        """Yield engine events for one request as they are produced; on
        GeneratorExit (consumer gone) cancel the request so its pages and
        slot free immediately."""
        if q is None:
            q = self._admit_streaming(req, tenant)
        deadline = time.monotonic() + self.request_timeout_s
        first = True
        try:
            while True:
                try:
                    event = q.get(timeout=min(5.0, max(0.1, deadline - time.monotonic())))
                except queue.Empty:
                    if time.monotonic() > deadline:
                        self.engine.cancel(req.request_id)
                        return
                    continue
                if first:
                    first = False
                    _observe_ttft(req, _deployment_tag(self.model_id),
                                  self.engine, tenant=tenant,
                                  ledger=self.tenancy)
                    self._note_residency(group, req)
                yield event
                if event["done"]:
                    return
        finally:
            self._token_queues.pop(req.request_id, None)
            self.tenancy.note_tokens(tenant, len(req.generated))
            self.tenancy.note_actual(
                tenant, len(req.prompt) + req.max_new_tokens,
                len(req.prompt) + len(req.generated))
            if not req.done:
                self.engine.cancel(req.request_id)

    # ------------------------------------------------------- OpenAI routes
    def completions(self, body: dict):
        """POST /v1/completions (OpenAI-compatible; reference
        ``routers/router.py:173``). ``"stream": true`` => SSE generator.
        On a prefill-pool replica the request is prefilled locally and
        handed off to a decode replica (``_disagg_request``)."""
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if self._role == "prefill" and self._decode_handle is not None:
            return self._disagg_request(body, prompt, chat=False)
        return self._local_completion(body, prompt, chat=False)

    def chat_completions(self, body: dict):
        """POST /v1/chat/completions: flatten messages with a minimal
        template, then the completion path."""
        prompt = _render_chat(body.get("messages", []))
        if self._role == "prefill" and self._decode_handle is not None:
            return self._disagg_request(body, prompt, chat=True)
        return self._local_completion(body, prompt, chat=True)

    def _local_completion(self, body: dict, prompt: str, chat: bool):
        """Serve one completion on THIS replica's engine (the unified
        path, and the decode half of a disaggregated handoff)."""
        max_tokens = int(body.get("max_tokens", 16))
        temperature = float(body.get("temperature", 0.0))
        cid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        if not body.get("stream"):
            out = self.generate(prompt, max_tokens, temperature,
                                model=body.get("model"),
                                session_id=body.get("session_id"),
                                deadline=self._effective_deadline(body))
            usage = {
                "prompt_tokens": len(self.tokenizer.encode(prompt)),
                "completion_tokens": out["num_generated"],
                "total_tokens": len(self.tokenizer.encode(prompt))
                + out["num_generated"],
            }
            if chat:
                return {
                    "id": cid, "object": "chat.completion",
                    "created": created,
                    "model": body.get("model", self.model_id),
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant",
                                    "content": out["text"]},
                        "finish_reason": _openai_finish(out["finish_reason"]),
                    }],
                    "usage": usage,
                }
            return {
                "id": cid, "object": "text_completion", "created": created,
                "model": body.get("model", self.model_id),
                "choices": [{
                    "index": 0, "text": out["text"],
                    "finish_reason": _openai_finish(out["finish_reason"]),
                    "logprobs": None,
                }],
                "usage": usage,
            }
        return self._sse_completion_stream(body, prompt, cid, created,
                                           chat=chat)

    # -------------------------------------------- disaggregated serving
    def migrated_completions(self, migration: dict, body: dict):
        """Decode-pool entry point for a disaggregated handoff: pull the
        prefill replica's KV pages over the migration stream (the import
        overlaps the source's still-running prefill), register them, and
        serve the request as an ordinary local completion — admission
        maps the imported prefix, so only the final prompt token's
        hidden state is computed here before decode begins."""
        migration = migration or {}
        chat = bool(migration.get("chat"))
        if chat:
            prompt = _render_chat(body.get("messages", []))
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
        self._import_migration(migration)
        return self._local_completion(body, prompt, chat=chat)

    def _import_migration(self, migration: dict) -> None:
        addr = migration.get("kv_address")
        if not addr or not self.engine.supports_kv_migration:
            return
        t0w = time.time()
        try:
            from .migration import receive_kv_stream

            stats = receive_kv_stream(self.engine, addr)
            attrs = {k: stats.get(k) for k in
                     ("cached_tokens", "pages", "bytes", "seconds",
                      "complete", "status")}
        except Exception as e:  # never fail the request over a transfer
            attrs = {"status": f"{type(e).__name__}: {e}",
                     "complete": False}
        attrs["kind"] = "disagg_handoff"
        if attrs.get("complete"):
            # Mark the NEXT request this thread creates (the migrated
            # completion below) with a flight-recorder migrate event.
            self._migrate_tls.tokens = int(attrs.get("cached_tokens") or 0)
        self._record_kv_migrate_span(t0w, attrs)

    def _disagg_request(self, body: dict, prompt: str, chat: bool):
        """Prefill-pool ingress (DistServe-style split): chunk-prefill
        the prompt on THIS replica (``prefill_only`` — no token is
        sampled), stream its KV pages to a decode replica WHILE later
        chunks are still prefilling, and relay the decode replica's
        response. TTFT-bound prefill and ITL-bound decode never share a
        replica, and the handoff latency hides behind prefill compute.
        If the decode pool is unreachable the request falls back to
        local serving — the prefix just prefilled is cached, so the
        fallback costs one suffix token."""
        from .migration import KVMigrationSource

        ids = self.tokenizer.encode(prompt)
        migration: dict = {"chat": chat}
        src = None
        rid = None
        if self.engine.supports_kv_migration and len(ids) > 1 \
                and not body.get("model"):
            rid = self._next_rid()
            req = Request(rid, list(ids), max_new_tokens=1,
                          prefill_only=True, pin_for_export=True)
            # Invalid prompts raise here, exactly like the local path.
            self.engine.add_request(req)
            try:
                src = KVMigrationSource(self.engine, req)
                migration["kv_address"] = src.address
                migration["prompt_len"] = len(ids)
            except Exception:
                self.engine.cancel(rid)
                src = None
        group = self._group_of(prompt, body.get("session_id"))
        handle = self._decode_handle.options(
            method_name="migrated_completions",
            prefix_group=group or f"mig:{uuid.uuid4().hex[:8]}",
            deadline=self._effective_deadline(body))
        if not body.get("stream"):
            try:
                out = handle.remote(migration, body).result(
                    timeout=self.request_timeout_s)
            except Exception:
                out = None
            finally:
                if src is not None:
                    src.close()
            if out is not None:
                return out
            return self._local_completion(body, prompt, chat)
        try:
            stream = handle.remote_streaming(migration, body)
        except Exception:
            # decode pool unreachable: serve locally off the hot prefix
            if rid is not None:
                self.engine.cancel(rid)
            if src is not None:
                src.close()
            return self._local_completion(body, prompt, chat)

        def relay():
            try:
                for msg in stream:
                    kind = msg.get("kind")
                    if kind == "start":
                        yield {"__serve_response__": True,
                               "content_type": msg.get(
                                   "content_type", "text/event-stream")}
                    elif kind == "chunk":
                        yield msg.get("data", b"")
                    elif kind == "error":
                        raise RuntimeError(msg.get("error", "decode failed"))
                    elif kind == "full":
                        yield json.dumps(msg.get("data")).encode()
            finally:
                try:
                    stream.close()
                except Exception:
                    pass
                if rid is not None:
                    self.engine.cancel(rid)  # no-op once prefilled
                if src is not None:
                    src.close()

        return relay()

    def export_prefix_kv(self, prompt: str, model: str | None = None):
        """Handle/actor entry point: export this replica's cached KV
        covering ``prompt``'s longest prefix as ONE blocking payload
        (``open_prefix_kv_stream`` is the chunked streaming form the
        spill pull uses)."""
        ids = self.tokenizer.encode(prompt)
        return self.engine.export_prefix_kv(ids, self._adapter_for(model))

    def open_prefix_kv_stream(self, prompt: str,
                              model: str | None = None) -> dict | None:
        """Handle/actor entry point (spill migration): open a chunked
        ``KVMigrationSource`` stream over this replica's cached KV
        covering ``prompt``'s longest prefix, so the spill target
        imports chunk-by-chunk — a slow or dying source degrades to the
        received prefix exactly like the disaggregation handoff.
        Returns ``{"kv_address": ...}`` or None when nothing is cached."""
        from .migration import KVMigrationSource

        ids = self.tokenizer.encode(prompt)
        src = KVMigrationSource.for_cached_prefix(
            self.engine, ids, self._adapter_for(model))
        if src is None:
            return None
        self._track_spill_source(src)
        return {"kv_address": src.address}

    def _track_spill_source(self, src) -> None:
        """Keep remotely-opened spill exporters until their streams
        drain, reaping finished ones (and force-closing the oldest past
        the cap) on each new open — the server socket outlives the
        exporter thread until close()."""
        with self._lock:
            sources = getattr(self, "_spill_sources", [])
            keep = []
            for s in sources:
                if s._thread.is_alive() and len(keep) < 7:
                    keep.append(s)
                else:
                    try:
                        s.close()
                    except Exception:
                        pass
            keep.append(src)
            self._spill_sources = keep

    def _maybe_spill_migrate(self, prompt: str,
                             model: str | None = None) -> None:
        """An affinity spill used to throw the group's cached KV away
        (PR-10 residue b): when the router ships the previous affine
        replica's identity with a spilled request, pull the group's hot
        pages from it over the CHUNKED migration stream and import them
        as they arrive — migrate-instead-of-recompute, with
        disaggregation on OR off, degrading to the received prefix when
        the source slows or dies mid-pull. Failure of any step falls
        back to the old behavior (cold prefill)."""
        from ..serve.router import get_migration_source

        src = get_migration_source()
        if not src or not self.engine.supports_kv_migration:
            return
        from ..core.config import get_config

        if not get_config().serve_spill_migration:
            return
        t0w = time.time()
        attrs: dict = {"kind": "spill", "source": src.get("replica_id", "")}
        try:
            from ..core import api as ray
            from ..core.api import ActorHandle

            from .migration import receive_kv_stream

            actor = ActorHandle(bytes.fromhex(src["actor_id"]))
            reply = ray.get(
                actor.handle_request.remote(
                    "open_prefix_kv_stream", (prompt, model), {}),
                timeout=30)
            addr = (reply or {}).get("kv_address")
            if addr:
                stats = receive_kv_stream(self.engine, addr)
                attrs.update({k: stats.get(k) for k in
                              ("cached_tokens", "pages", "bytes",
                               "seconds", "complete", "status")})
            else:
                attrs["status"] = "nothing cached"
        except Exception as e:
            attrs["status"] = f"{type(e).__name__}: {e}"
        self._record_kv_migrate_span(t0w, attrs)

    def _record_kv_migrate_span(self, t0w: float, attrs: dict) -> None:
        """One ``llm.kv_migrate`` span per migration (disagg handoff or
        spill pull), chained under the request's trace context."""
        try:
            from ..observability import tracing

            ctx = tracing.current()
            tracing.record_span(tracing.make_span(
                "llm.kv_migrate", "llm", t0w, time.time(),
                ctx.trace_id if ctx else tracing.new_trace_id(),
                ctx.span_id if ctx else "", attrs=attrs))
        except Exception:
            pass

    def _sse_completion_stream(self, body: dict, prompt: str, cid: str,
                               created: int, chat: bool):
        """SSE generator: one ``data:`` event per token, ``[DONE]`` last
        (OpenAI stream framing; flows through Serve's streaming path to the
        proxy as chunked ``text/event-stream``)."""
        model = body.get("model", self.model_id)
        max_tokens = int(body.get("max_tokens", 16))
        temperature = float(body.get("temperature", 0.0))
        obj = "chat.completion.chunk" if chat else "text_completion"
        ids = self.tokenizer.encode(prompt)
        rid = self._next_rid()
        req = Request(rid, ids, max_tokens, temperature,
                      eos_id=self.tokenizer.eos_id,
                      model=self._adapter_for(body.get("model")),
                      deadline=self._effective_deadline(body))
        self._take_migrate_mark(req)
        group = self._group_of(prompt, body.get("session_id"))
        tenant = self._tenant_for(body.get("model"))

        def gen():
            self._maybe_spill_migrate(prompt, body.get("model"))
            # Admit BEFORE the response head: a bounded-queue shed, a
            # quota-exhausted 429, or an invalid prompt surfaces on a
            # clean error status instead of a truncated 200 stream.
            q = self._admit_streaming(req, tenant)
            yield {"__serve_response__": True, "content_type": "text/event-stream"}
            if chat:
                head = {"id": cid, "object": obj, "created": created, "model": model,
                        "choices": [{"index": 0, "delta": {"role": "assistant"},
                                     "finish_reason": None}]}
                yield f"data: {json.dumps(head)}\n\n"
            for event in self._stream_tokens(req, group, q=q,
                                             tenant=tenant):
                # Terminal-only events (deadline expiry) carry token -1:
                # no text, just the finish_reason.
                text = (self.tokenizer.decode([event["token"]])
                        if event["token"] >= 0 else "")
                if chat:
                    choice = {"index": 0, "delta": {"content": text},
                              "finish_reason": _openai_finish(event["finish_reason"]) if event["done"] else None}
                else:
                    choice = {"index": 0, "text": text, "logprobs": None,
                              "finish_reason": _openai_finish(event["finish_reason"]) if event["done"] else None}
                chunk = {"id": cid, "object": obj, "created": created,
                         "model": model, "choices": [choice]}
                yield f"data: {json.dumps(chunk)}\n\n"
            yield "data: [DONE]\n\n"

        return gen()

    def models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.model_id, "object": "model", "created": 0,
            "owned_by": "ray_tpu",
        }]}

    def engine_metrics(self) -> dict:
        return {**self.engine.metrics,
                "prefix_cache_hit_rate": self.engine.prefix_cache_hit_rate,
                "prefill_suffix_frac": self.engine.prefill_suffix_frac,
                "mixed_dispatch_enabled": self.engine.mixed_dispatch_enabled,
                "speculation_enabled": self.engine.speculation_enabled,
                "spec_accept_rate": self.engine.spec_accept_rate,
                "spec_tokens_per_dispatch":
                    self.engine.spec_tokens_per_dispatch,
                "role": self._role,
                "supports_kv_migration": self.engine.supports_kv_migration,
                "port": self._port_stats()}

    def _port_stats(self) -> dict:
        """The port's own row of ``engine_metrics``: this replica's process,
        the device its engine runs on, and this process's launch counts
        of the paged decode kernels (per process, so a caller in another
        process reads a replica's counts only here), by CUDA source."""
        from ..ops.paged_attention import (paged_decode_kernel,
                                           paged_decode_split_kernel)

        device = self.engine.executor.device
        return {"pid": os.getpid(),
                "device": str(device),
                "device_name": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else None),
                "kernel_launches": {
                    "paged_decode_split": paged_decode_split_kernel.launches,
                    "paged_decode": paged_decode_kernel.launches}}

    def overload_stats(self) -> dict:
        """Engine-side overload counters, picked up by the replica
        actor's ``latency_snapshot`` probe (``serve_overload`` row) and
        folded into ``serve.status()`` per deployment."""
        m = self.engine.metrics
        return {"deadline_expired_queued": m["deadline_expired_queued"],
                "deadline_expired_running": m["deadline_expired_running"],
                "queue_rejects": m["queue_rejects"],
                "admission_rejects": m["admission_rejects"]}

    def tenancy_stats(self) -> dict:
        """Per-tenant rows + adapter residency for this replica, picked
        up by the replica actor's ``latency_snapshot`` probe
        (``serve_tenancy`` row) and folded into ``serve.status()`` /
        ``cli serve status`` per-tenant tables."""
        out: dict = {"tenants": self.tenancy.snapshot(),
                     "adapter_defers":
                         self.engine.metrics.get("adapter_defers", 0),
                     # Most recent flight-recorder breach dumps (deadline
                     # expiries / sheds / TTFT-SLO breaches) on this
                     # replica — the serve.status() "last breach" rows.
                     "last_breaches": self.engine.breach_samples()}
        lm = self.engine.lora_manager
        if lm is not None:
            out["adapters"] = lm.stats()
            out["resident_adapters"] = list(lm.resident())
        return out

    def pool_stats(self) -> dict:
        """Engine page-pool accounting (chaos invariant surface)."""
        return self.engine.pool_stats()

    # ------------------------------------------------------ fleet lifecycle
    def fleet_stats(self) -> dict:
        """Per-replica fleet row, picked up by the replica actor's
        ``latency_snapshot`` probe (``serve_fleet``) and folded by the
        controller into the scale-to-zero / standby decisions: how long
        since the last request landed here, and where the weights are."""
        eng = self.engine
        with self._lock:
            last = self._last_request_ts
        idle = 0.0 if eng.has_work else max(0.0, time.time() - last)
        return {"idle_s": round(idle, 3),
                "residency_capable": eng.supports_weight_residency,
                "weights_on_host": not eng.weights_resident(),
                "weights_demoted": eng.metrics.get("weights_demoted", 0),
                "weights_promoted": eng.metrics.get("weights_promoted", 0),
                "weight_promote_ms":
                    eng.metrics.get("weight_promote_ms", 0.0)}

    def fleet_demote(self) -> dict:
        """Standby demotion: weights to host RAM + idle-adapter unload.
        Refused (``ok=False, reason="busy"``) while requests are in
        flight — the controller just retries next reconcile round."""
        return self.engine.demote_weights_to_host()

    def fleet_promote(self, weight_address: str | None = None) -> dict:
        """Promotion ladder: broadcast stream (when the controller hands
        us a donor's ``weight_address``) → host-RAM copy → deterministic
        cold re-init. Each rung degrades to the next, so a donor dying
        mid-stream costs the faster path, never the promotion."""
        eng = self.engine
        t0 = time.monotonic()
        ladder = []
        if weight_address and eng.supports_weight_residency:
            from .weights import receive_weight_stream

            res = receive_weight_stream(weight_address,
                                        like=eng._host_params)
            if res["params"] is not None:
                out = eng.install_weights(res["params"])
                if out.get("ok"):
                    return {"ok": True, "path": "stream",
                            "bytes": res["bytes"],
                            "seconds": round(time.monotonic() - t0, 6)}
            ladder.append(f"stream:{res['status']}")
        out = eng.promote_weights_from_host()
        if out.get("ok"):
            path = "resident" if out.get("already") else "host"
            return {"ok": True, "path": path, "ladder": ladder,
                    "seconds": round(time.monotonic() - t0, 6)}
        ladder.append(f"host:{out.get('reason', '?')}")
        if eng.supports_weight_residency and not eng.weights_resident():
            # Last resort: weights here come from the seeded init, so a
            # cold re-init reproduces them bit-for-bit (the checkpoint
            # re-load of a real deployment): the executor's generator,
            # device, dtype and draw order.
            from ..models.llama import init_params

            params = init_params(
                eng.config,
                torch.Generator(eng.executor.device).manual_seed(self._seed))
            out = eng.install_weights(params)
            if out.get("ok"):
                return {"ok": True, "path": "cold_init", "ladder": ladder,
                        "seconds": round(time.monotonic() - t0, 6)}
            ladder.append(f"cold_init:{out.get('reason', '?')}")
        return {"ok": eng.weights_resident(), "path": "failed",
                "ladder": ladder,
                "seconds": round(time.monotonic() - t0, 6)}

    def open_weight_stream(self, n_readers: int = 1,
                           _die_after_chunks: int | None = None
                           ) -> dict | None:
        """Open a weight broadcast from this (warm or standby) replica:
        N cold/standby replicas stream ONE read of the weights instead
        of N independent loads. Rides the same source-reaping registry
        as the KV spill exporters. Returns ``{"weight_address",
        "fingerprint"}`` or None when there is nothing to serve."""
        eng = self.engine
        params = getattr(eng.executor, "params", None)
        if params is None:
            params = eng._host_params
        if params is None or not eng.supports_weight_residency:
            return None
        from .weights import WeightBroadcastSource

        src = WeightBroadcastSource(
            params, model=self.model_id, n_readers=n_readers,
            _die_after_chunks=_die_after_chunks)
        self._track_spill_source(src)
        return {"weight_address": src.address,
                "fingerprint": src.fingerprint}

    # ---------------------------------------------------------- HTTP entry
    def __call__(self, request):
        """HTTP ingress: OpenAI routes + the legacy ?prompt= GET."""
        path = request.path
        if path.endswith("/v1/models"):
            return self.models()
        try:
            if path.endswith("/v1/completions"):
                return self.completions(request.json())
            if path.endswith("/v1/chat/completions"):
                return self.chat_completions(request.json())
        except ValueError as e:
            # Invalid request (e.g. prompt >= max_len): OpenAI-style error
            # body instead of a bare 500.
            return {"error": {"message": str(e), "type": "invalid_request_error",
                              "code": 400}}
        q = request.query_params
        return self.generate(
            q.get("prompt", ""),
            max_new_tokens=int(q.get("max_new_tokens", 16)),
            temperature=float(q.get("temperature", 0.0)),
        )


def _openai_finish(reason: str) -> str:
    return {"stop": "stop", "length": "length", "max_len": "length",
            "timeout": "length", "cancelled": "stop"}.get(reason, reason or "stop")


def _render_chat(messages: list) -> str:
    """Minimal chat template (byte tokenizer has no special tokens)."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)


def build_llm_app(preset: str = "debug-128", *, num_replicas: int = 1,
                  max_slots: int = 8, max_len: int = 256,
                  page_size: int = 16, prefill_chunk_size: int = 64,
                  decode_steps_per_dispatch: int = 8, tensor_parallel: int = 1,
                  pipeline_parallel: int = 1,
                  num_hosts: int = 1, shard_resources: dict | None = None,
                  shard_runtime_env: dict | None = None,
                  topology: str | None = None,
                  max_ongoing_requests: int = 32, model_id: str | None = None,
                  ray_actor_options: dict | None = None,
                  attention_impl: str = "auto",
                  autoscaling_config=None,
                  prefill_token_budget: int | None = None,
                  max_prefill_seqs_per_step: int = 2,
                  decode_starvation_limit: int = 8,
                  use_compiled_loop: bool | None = None,
                  serve_disaggregation: str | None = None,
                  prefill_replicas: int = 1,
                  host_kv_cache_pages: int = 0,
                  max_queued_requests: int = 0,
                  admission_watermark_pages: int | None = None,
                  speculation_config=None,
                  lora_config: dict | None = None,
                  tenancy_config: dict | None = None,
                  device=None):
    """Build a Serve Application serving ``preset`` (serve.run-able).
    Pass ``ray_actor_options={"num_gpus": 1, ...}`` to give each replica
    (engine) a GPU lease; its worker then sees the host's cards, and the
    engine runs on the card (``device=None``) or where ``device`` says
    (``"cpu"``). Without a GPU lease a replica's worker sees no card; a
    fractional lease (``{"num_gpus": 0.5}``) lets two replicas share one.

    ``serve_disaggregation="prefill_decode"`` builds the DistServe-style
    split instead of one replica pool: ``prefill_replicas`` ingress
    replicas ("llm-prefill" pool) chunk-prefill prompts and live-migrate
    the KV pages to the ``num_replicas`` decode replicas ("llm-decode"
    pool), which own all token streaming — TTFT-bound and ITL-bound work
    never compete for a replica, and an affinity spill inside either
    pool migrates pages instead of recomputing them. ``num_hosts`` > 1
    and tensor or pipeline parallelism are not ported yet and raise
    ``NotImplementedError``."""
    from ..serve import deployment

    engine_kwargs = dict(
        model_id=model_id, max_slots=max_slots, max_len=max_len,
        page_size=page_size, prefill_chunk_size=prefill_chunk_size,
        decode_steps_per_dispatch=decode_steps_per_dispatch,
        tensor_parallel=tensor_parallel,
        pipeline_parallel=pipeline_parallel, num_hosts=num_hosts,
        shard_resources=shard_resources,
        shard_runtime_env=shard_runtime_env, topology=topology,
        attention_impl=attention_impl,
        prefill_token_budget=prefill_token_budget,
        max_prefill_seqs_per_step=max_prefill_seqs_per_step,
        decode_starvation_limit=decode_starvation_limit,
        use_compiled_loop=use_compiled_loop,
        host_kv_cache_pages=host_kv_cache_pages,
        max_queued_requests=max_queued_requests,
        admission_watermark_pages=admission_watermark_pages,
        speculation_config=speculation_config,
        lora_config=lora_config,
        tenancy_config=tenancy_config,
        device=device)
    if serve_disaggregation is None:
        dep = deployment(
            LLMDeployment,
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
        )
        return dep.bind(preset, **engine_kwargs)
    if serve_disaggregation != "prefill_decode":
        raise ValueError(
            f"unknown serve_disaggregation {serve_disaggregation!r} "
            "(use 'prefill_decode' or None)")
    decode_app = deployment(
        LLMDeployment,
        name="llm-decode",
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        autoscaling_config=autoscaling_config,
        ray_actor_options=ray_actor_options,
        pool="decode",
    ).bind(preset, role="decode", **engine_kwargs)
    return deployment(
        LLMDeployment,
        name="llm-prefill",
        num_replicas=max(1, prefill_replicas),
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options,
        pool="prefill",
    ).bind(preset, role="prefill", decode_handle=decode_app,
           **engine_kwargs)
