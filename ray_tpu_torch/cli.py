"""CLI: cluster state inspection (`python -m ray_tpu_torch.cli ...`).

Equivalent of the reference's `ray list ...` state CLI
(``python/ray/util/state/state_cli.py``) and `ray timeline`
(``python/ray/scripts/scripts.py``). Connects to a running cluster via
``--address`` (GCS address).

The port of ``ray_tpu/cli.py`` on the port's state API. It joins the
cluster through a raylet of its own that offers no CPU and no card, so
an operator's command never takes a node's work, and it leaves the
cluster when it exits. `status` also lists the pending resource demand
the raylets report (what the autoscaler reads); `profile` captures
through the worker's ``torch.profiler`` hook; `bench` is not ported yet
and exits 2.
"""

from __future__ import annotations

import argparse
import atexit
import json
import sys


def _connect(address: str | None) -> None:
    import ray_tpu_torch

    if address:
        # GPU 0: the raylet would otherwise advertise this host's cards.
        ray_tpu_torch.init(address=address, num_cpus=0, resources={"GPU": 0})
        # The command's raylet leaves with it: its store segment too.
        atexit.register(ray_tpu_torch.shutdown)
    elif not ray_tpu_torch.is_initialized():
        print("error: pass --address GCS_HOST:PORT of a running cluster", file=sys.stderr)
        raise SystemExit(2)


def _print_table(rows: list[dict], columns: list[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))[:48]) for r in rows)) for c in columns}
    print("  ".join(c.upper().ljust(widths[c]) for c in columns))
    for r in rows:
        print("  ".join(str(r.get(c, ""))[:48].ljust(widths[c]) for c in columns))


def _cmd_chaos(args) -> int:
    from ray_tpu_torch import chaos as chaos_mod

    if args.chaos_cmd == "plans":
        rows = [{"name": name, "description": p.get("description", "")}
                for name, p in chaos_mod.BUILTIN_PLANS.items()]
        if args.as_json:
            print(json.dumps(rows, indent=2))
        else:
            _print_table(rows, ["name", "description"])
        return 0
    # chaos run
    plan = chaos_mod.load_plan(args.plan)
    schedule = plan.compile(args.seed)
    if args.dry_run:
        # Canonical bytes: two runs with the same plan + seed must print
        # identical output (the reproducibility contract).
        sys.stdout.write(schedule.canonical_bytes().decode() + "\n")
        return 0
    _connect(args.address)
    try:
        report = chaos_mod.run_plan(
            plan, seed=args.seed, verify=not args.no_verify,
            verify_timeout_s=args.verify_timeout)
    except chaos_mod.ChaosVerificationError as e:
        print(f"RECOVERY VERIFICATION FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, default=str))
    return 0


def _cmd_bench(args) -> int:
    # The standalone benchmark suites are not ported yet: each is its own
    # harness in the JAX package (ROADMAP queue A item 10).
    print("error: `bench` is not ported yet: the benchmark suites wait for "
          "ROADMAP queue A item 10 (the _*_bench.py harnesses, _perf.py, "
          "bench_check.py and serve/microbench.py)", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch", description=__doc__)
    parser.add_argument("--address", help="GCS address of a running cluster")
    parser.add_argument("--json", action="store_true", dest="as_json")
    sub = parser.add_subparsers(dest="cmd", required=True)

    list_p = sub.add_parser("list", help="list cluster entities")
    list_p.add_argument("what", choices=["nodes", "actors", "tasks", "workers",
                                         "objects", "placement-groups", "errors"])
    sub.add_parser("summary", help="task counts by name and state")
    tl = sub.add_parser("timeline", help="dump a chrome://tracing file")
    tl.add_argument("-o", "--output", default="timeline.json")
    tr = sub.add_parser(
        "trace", help="list recent traces, or show one trace's span tree")
    tr.add_argument("trace_id", nargs="?",
                    help="trace id (omit to list recent traces)")
    tr.add_argument("--limit", type=int, default=20)
    tr.add_argument("--request", default=None, metavar="REQUEST_ID",
                    help="show the flight-recorder timeline dumped for "
                         "one LLM request on SLO breach (deadline "
                         "expiry, shed, TTFT-SLO breach)")
    loop_p = sub.add_parser(
        "loop", help="compiled-loop stall attribution")
    loop_sub = loop_p.add_subparsers(dest="loop_cmd", required=True)
    ltop = loop_sub.add_parser(
        "top", help="live per-stage wait_up/compute/wait_down splits and "
                    "the bottleneck stage for every compiled loop this "
                    "process owns (loops are driver-local; run in the "
                    "driver, or point a dashboard at /api/loops)")
    ltop.add_argument("--once", action="store_true",
                      help="print one snapshot and exit (no live refresh)")
    ltop.add_argument("--interval", type=float, default=2.0,
                      help="refresh period in seconds (default 2)")
    sub.add_parser("metrics", help="aggregated metrics (Prometheus text format)")
    sub.add_parser("status", help="cluster resource overview")
    doctor_p = sub.add_parser(
        "doctor", help="aggregate per-node debug state + recent error events")
    doctor_p.add_argument("--errors", type=int, default=10,
                          help="recent error events to show")
    mem_p = sub.add_parser(
        "memory", help="`ray memory`-style cluster view: per-worker object "
                       "refs with size, ref type, and creation callsite")
    mem_p.add_argument("--group-by-callsite", action="store_true",
                       help="aggregate holders per creation callsite")
    prof_p = sub.add_parser(
        "profile", help="capture an on-demand torch.profiler trace on a "
                        "worker (host ops, and the card's kernels where the "
                        "worker has initialized CUDA) as a Chrome trace")
    prof_p.add_argument("--node", default=None,
                        help="node id prefix (default: the driver's node)")
    prof_p.add_argument("--worker", default=None, help="specific worker id")
    prof_p.add_argument("--duration", type=float, default=5.0,
                        help="capture length in seconds")
    prof_p.add_argument("--list", action="store_true", dest="list_profiles",
                        help="list previously captured artifacts instead")
    bench_p = sub.add_parser(
        "bench", help="run a benchmark suite standalone (not ported yet: "
                      "exits 2)")
    bench_p.add_argument("bench_cmd", nargs="?", default=None)
    bench_p.add_argument("rest", nargs=argparse.REMAINDER)
    serve_p = sub.add_parser(
        "serve", help="Serve control-plane inspection")
    serve_sub = serve_p.add_subparsers(dest="serve_cmd", required=True)
    serve_sub.add_parser(
        "status", help="apps, deployments, replica counts, autoscaling "
                       "mode and the recent scale decisions with their "
                       "trigger metric (TTFT p95 etc.)")
    chaos_p = sub.add_parser(
        "chaos", help="deterministic fault injection (seeded FaultPlans)")
    chaos_sub = chaos_p.add_subparsers(dest="chaos_cmd", required=True)
    crun = chaos_sub.add_parser(
        "run", help="run a fault plan against the cluster, then verify "
                    "recovery (tasks terminal, lease queues drained, "
                    "refcounts at baseline)")
    crun.add_argument("plan", help="plan YAML path or a bundled plan name "
                                   "(see `chaos plans`)")
    crun.add_argument("--seed", type=int, default=0,
                      help="schedule seed — same plan+seed compiles to a "
                           "byte-identical fault schedule")
    crun.add_argument("--dry-run", action="store_true",
                      help="print the compiled fault schedule (canonical "
                           "JSON) without touching a cluster")
    crun.add_argument("--no-verify", action="store_true")
    crun.add_argument("--verify-timeout", type=float, default=60.0)
    chaos_sub.add_parser("plans", help="list bundled fault plans")

    args = parser.parse_args(argv)
    if args.cmd == "bench":
        return _cmd_bench(args)
    if args.cmd == "chaos":
        return _cmd_chaos(args)
    _connect(args.address)
    import ray_tpu_torch
    from ray_tpu_torch.util import state as st

    if args.cmd == "list":
        what = args.what
        if what == "nodes":
            rows, cols = st.list_nodes(), ["node_id", "address", "state"]
        elif what == "actors":
            rows, cols = st.list_actors(), ["actor_id", "name", "state", "address"]
        elif what == "tasks":
            rows, cols = st.list_tasks(), ["task_id", "name", "state", "node_id"]
        elif what == "workers":
            rows, cols = st.list_workers(), ["worker_id", "state", "pid", "node_id"]
        elif what == "objects":
            rows, cols = st.list_objects(), ["object_id", "size", "state",
                                             "ref_type", "callsite", "node_id"]
        elif what == "errors":
            rows, cols = st.list_errors(), ["type", "source", "node_id", "message"]
        else:
            rows, cols = st.list_placement_groups(), ["pg_id", "state", "strategy"]
        print(json.dumps(rows, indent=2, default=str) if args.as_json else "", end="")
        if not args.as_json:
            _print_table(rows, cols)
    elif args.cmd == "summary":
        print(json.dumps(st.summarize_tasks(), indent=2))
    elif args.cmd == "timeline":
        path = ray_tpu_torch.timeline(args.output)
        print(f"wrote {path}")
    elif args.cmd == "trace":
        from ray_tpu_torch.observability import format_trace_tree

        if args.request:
            span = st.find_request_timeline(args.request)
            if span is None:
                print(f"no llm.request_timeline dump for request "
                      f"{args.request!r} (dumps fire on SLO breach: "
                      f"deadline expiry, shed, or TTFT-SLO breach)")
                return 1
            if args.as_json:
                print(json.dumps(span, indent=2, default=str))
            else:
                attrs = span.get("attrs") or {}
                print(f"request {args.request}  reason={attrs.get('reason')}"
                      f"  events={attrs.get('n_events')}"
                      f"  dropped={attrs.get('dropped')}")
                t0 = None
                for ev in attrs.get("events") or []:
                    t = float(ev.get("t", 0.0))
                    if t0 is None:
                        t0 = t
                    pin = " (pinned)" if ev.get("pinned") else ""
                    print(f"  +{1000 * (t - t0):9.3f} ms  "
                          f"{str(ev.get('ev', '?')):16s} "
                          f"value={ev.get('v', 0)}{pin}")
        elif args.trace_id:
            spans = st.list_spans(trace_id=args.trace_id)
            if args.as_json:
                print(json.dumps(spans, indent=2, default=str))
            else:
                print(format_trace_tree(spans))
        else:
            rows = st.list_traces(limit=args.limit)
            if args.as_json:
                print(json.dumps(rows, indent=2, default=str))
            else:
                _print_table(rows, ["trace_id", "root", "spans", "duration_ms"])
    elif args.cmd == "loop":
        import time as _time

        def _loop_rows():
            rows = []
            for loop in st.loop_stats():
                for name, s in (loop.get("stages") or {}).items():
                    frac = s.get("frac") or {}
                    rows.append({
                        "loop": loop.get("loop_id", "")[:12],
                        "stage": name,
                        "ticks": s.get("ticks", 0),
                        "wait_up": f"{frac.get('wait_up', 0.0):.0%}",
                        "compute": f"{frac.get('compute', 0.0):.0%}",
                        "wait_down": f"{frac.get('wait_down', 0.0):.0%}",
                        "state": s.get("state", ""),
                        "bottleneck": ("<-- bottleneck"
                                       if loop.get("bottleneck") == name
                                       else ""),
                    })
            return rows

        cols = ["loop", "stage", "ticks", "wait_up", "compute",
                "wait_down", "state", "bottleneck"]
        while True:
            rows = _loop_rows()
            if args.as_json:
                print(json.dumps(st.loop_stats(), indent=2, default=str))
            elif rows:
                _print_table(rows, cols)
            else:
                print("no live compiled loops in this process "
                      "(loops are driver-local; run inside the driver or "
                      "query the dashboard's /api/loops)")
            if args.once:
                break
            try:
                _time.sleep(max(0.1, args.interval))
            except KeyboardInterrupt:
                break
            print("\x1b[2J\x1b[H", end="")  # clear + home for the refresh
    elif args.cmd == "metrics":
        from ray_tpu_torch.util.metrics import get_metrics, prometheus_text

        print(prometheus_text(get_metrics()), end="")
    elif args.cmd == "status":
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        nodes = st.list_nodes()
        print(f"nodes: {sum(1 for n in nodes if n['state'] == 'ALIVE')} alive / {len(nodes)}")
        for k in sorted(total):
            print(f"  {k}: {avail.get(k, 0.0):g} / {total[k]:g} available")
        # The lease shapes the raylets cannot place: the autoscaler's demand.
        demand: dict[str, int] = {}
        for n in nodes:
            if n["state"] != "ALIVE":
                continue
            for d in n.get("pending_demand") or []:
                shape = ", ".join(f"{k}: {v:g}"
                                  for k, v in sorted(d["shape"].items()))
                demand[shape] = demand.get(shape, 0) + int(d["count"])
        print("pending demand:" + ("" if demand else " (none)"))
        for shape, count in sorted(demand.items()):
            print(f"  {{{shape}}} x {count}")
    elif args.cmd == "doctor":
        diag = st.cluster_diagnostics(error_limit=args.errors)
        if args.as_json:
            print(json.dumps(diag, indent=2, default=str))
            return 0
        gcs = diag["gcs"]
        print("GCS: nodes=%s actors=%s placement_groups=%s errors_buffered=%s" % (
            gcs.get("nodes_by_state", {}), gcs.get("actors_by_state", {}),
            gcs.get("placement_groups_by_state", {}), gcs.get("errors_buffered", 0)))
        plan = diag.get("active_fault_plan")
        if plan:
            print("ACTIVE FAULT PLAN: %s (seed=%s, digest=%s) — failures "
                  "below may be chaos-injected" % (
                      plan.get("name"), plan.get("seed"), plan.get("digest")))
        rows = []
        for snap in diag["nodes"]:
            queue = snap.get("lease_queue") or []
            store = snap.get("store") or {}
            rows.append({
                "node_id": snap.get("node_id", ""),
                "lease_queue": snap.get("lease_queue_depth", "?"),
                "oldest_wait_s": max((e["age_s"] for e in queue), default=0.0),
                "workers": snap.get("num_workers", "?"),
                "idle": snap.get("idle_workers", "?"),
                "store_used": store.get("used", "?"),
                "wedges": snap.get("wedge_events_total", 0),
                "orphans": snap.get("orphan_leases_total", 0),
                "oom_kills": snap.get("oom_kills_total", 0),
            })
        print("per-node lease queues / worker pools:")
        _print_table(rows, ["node_id", "lease_queue", "oldest_wait_s", "workers",
                            "idle", "store_used", "wedges", "orphans",
                            "oom_kills"])
        errors = diag["errors"]
        print(f"recent errors ({len(errors)}):")
        for e in errors:
            print("  [%s/%s] node=%s %s" % (
                e.get("source", "?"), e.get("type", "?"),
                (e.get("node_id") or "")[:8],
                str(e.get("message", "")).splitlines()[0][:120] if e.get("message") else ""))
    elif args.cmd == "memory":
        summary = st.memory_summary()
        if args.as_json:
            print(json.dumps(summary, indent=2, default=str))
            return 0
        if args.group_by_callsite:
            from ray_tpu_torch.observability.memory import _top_holders

            entries = [e for w in summary.get("workers", [])
                       for e in w.get("entries", [])]
            print("%-52s %8s %12s  %s" % ("CALLSITE", "REFS", "BYTES", "REF_TYPES"))
            for h in _top_holders(entries, top_k=50):
                print("%-52s %8d %12d  %s" % (
                    h["callsite"][:52], h["count"], h["bytes"],
                    ",".join(h["ref_types"])))
            return 0
        from ray_tpu_torch.observability import format_memory_summary

        print(format_memory_summary(summary, st.list_nodes()))
    elif args.cmd == "serve":
        from ray_tpu_torch import serve as serve_api

        try:
            status = serve_api.status()
        except ValueError:
            print("no Serve instance running")
            return 1
        if args.as_json:
            print(json.dumps(status, indent=2, default=str))
            return 0
        if not status:
            print("no Serve applications deployed")
            return 0
        import datetime

        for app, deps in status.items():
            for name, st in deps.items():
                mode = st.get("autoscaling_mode") or "static"
                line = (f"{app}/{name}: {st['running_replicas']}/"
                        f"{st['target_replicas']} replicas "
                        f"[{'healthy' if st['healthy'] else 'UNHEALTHY'}] "
                        f"autoscaling={mode}")
                if st.get("last_start_failure"):
                    line += (" last_start_failure="
                             + str(st["last_start_failure"]).splitlines()[0][:80])
                print(line)
                ovl = dict(st.get("overload") or {})
                router_ovl = ovl.pop("router", None) or {}
                parts = [f"{k}={v}" for k, v in sorted(ovl.items())
                         if k != "replicas" and v]
                shed = router_ovl.get("shed") or {}
                parts += [f"shed_{k}={v}" for k, v in sorted(shed.items())]
                if router_ovl.get("deadline_expired_queued"):
                    parts.append("router_deadline_expired="
                                 + str(router_ovl["deadline_expired_queued"]))
                circuit = router_ovl.get("circuit") or {}
                if router_ovl.get("circuit_opens"):
                    parts.append(f"circuit_opens={router_ovl['circuit_opens']}")
                for rid, cst in sorted(circuit.items()):
                    parts.append(f"circuit[{rid}]={cst}")
                if parts:
                    print("  overload: " + " ".join(parts))
                # Always-warm fleet: standby pool, scale-to-zero park,
                # and the last standby promotion with its path/timing.
                if st.get("standby_replicas") or st.get("scaled_to_zero") \
                        or st.get("last_promote"):
                    fparts = [f"standby={st.get('standby_replicas', 0)}"]
                    if st.get("scaled_to_zero"):
                        fparts.append("scaled_to_zero")
                    fl = st.get("fleet") or {}
                    if fl.get("idle_s") is not None:
                        fparts.append(f"idle_s={round(fl['idle_s'], 1)}")
                    if fl.get("host_resident"):
                        fparts.append(f"host_resident={fl['host_resident']}")
                    lp = st.get("last_promote") or {}
                    if lp:
                        fparts.append(
                            f"last_promote={lp.get('path')}"
                            f"/{round(float(lp.get('seconds') or 0), 3)}s")
                    print("  fleet: " + " ".join(fparts))
                ten = dict(st.get("tenancy") or {})
                resident = ten.get("resident_adapters") or []
                if resident or ten.get("adapter_defers"):
                    line = "  adapters: resident=" + (",".join(resident) or "-")
                    if ten.get("adapter_defers"):
                        line += f" defers={ten['adapter_defers']}"
                    print(line)
                scope = ten.get("scope")
                for tenant, row in sorted((ten.get("tenants") or {}).items()):
                    tparts = [f"admitted={row.get('admitted', 0)}"]
                    for k in ("shed", "quota_rejects"):
                        if row.get(k):
                            tparts.append(f"{k}={row[k]}")
                    if row.get("quota_remaining") is not None:
                        tparts.append(
                            f"quota_remaining={row['quota_remaining']}")
                    if row.get("p95_ttft_ms") is not None:
                        tparts.append(
                            f"p95_ttft_ms={round(float(row['p95_ttft_ms']), 1)}")
                    if row.get("slo_burn_frac") is not None:
                        tparts.append(
                            f"slo_burn={float(row['slo_burn_frac']):.0%}")
                    if row.get("cost_correction") is not None:
                        tparts.append(
                            f"cost_corr={row['cost_correction']}")
                    if scope:
                        tparts.append(f"scope={scope}")
                    print(f"  tenant[{tenant}]: " + " ".join(tparts))
                for b in (ten.get("last_breaches") or [])[-3:]:
                    ts = datetime.datetime.fromtimestamp(
                        b.get("ts", 0.0)).strftime("%H:%M:%S")
                    print(f"  breach[{ts}] request={b.get('request_id')} "
                          f"reason={b.get('reason')} "
                          f"events={b.get('n_events')} "
                          f"(full dump: cli trace --request "
                          f"{b.get('request_id')})")
                for e in st.get("autoscale_events") or []:
                    ts = datetime.datetime.fromtimestamp(e["ts"]).strftime(
                        "%H:%M:%S")
                    print(f"  [{ts}] scale {e['from']} -> {e['to']} "
                          f"({e['trigger']}={e['value']} vs target "
                          f"{e['target']})")
    elif args.cmd == "profile":
        if args.list_profiles:
            rows = st.list_profiles()
            if args.as_json:
                print(json.dumps(rows, indent=2, default=str))
            else:
                _print_table(rows, ["path", "node_id", "worker_id", "duration"])
            return 0
        reply = st.capture_profile(node_id=args.node, duration=args.duration,
                                   worker_id=args.worker)
        if reply.get("error"):
            print(f"error: {reply['error']}", file=sys.stderr)
            return 1
        print(json.dumps(reply, indent=2, default=str) if args.as_json
              else f"wrote {reply['path']} (worker {reply.get('worker_id', '')[:12]}, "
                   f"{reply.get('duration')}s) — open its trace.json in "
                   f"Perfetto")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
