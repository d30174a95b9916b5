"""REST deployment service.

The port's copy of the JAX package's ``service.py``, with one difference: a
service that builds its own manager builds it as ``SiddhiManager(device)``
(``device=None``, the default, is the card; ``"cpu"`` runs the plain
versions). The ``fleet`` and ``slo`` endpoints read the port's fleet tier
and the ``dcn`` endpoint its DCN tier (a ``gpu/dcn.py`` ``DCNWorker``
attached as ``runtime.dcn_worker``); the ``mesh`` endpoint reads a tier the
port does not have yet (``ROADMAP.md`` §A item 8) through ``getattr`` and
answers ``enabled: false`` as the JAX package's does without it.

Reference: ``modules/siddhi-service`` —
``impl/SiddhiApiServiceImpl.java:45`` (deploy ``:51``, undeploy ``:100``): a
small HTTP wrapper that deploys SiddhiQL app text onto a shared
``SiddhiManager``, keeps runtimes + input handlers by app name, and undeploys
on request. Endpoints (stdlib http.server, threaded; no framework deps):

    POST   /siddhi-apps                      body = SiddhiQL text → deploy+start
    GET    /siddhi-apps                      list deployed app names
    GET    /siddhi-apps/{name}/status        {"state": "running"|"stopped"}
    GET    /siddhi-apps/{name}/flow          flow-control stats (WAL bytes,
                                             watermarks, queue depth/credits,
                                             shed counts, adaptive batch size)
    POST   /siddhi-apps/{name}/recover       checkpoint restore + WAL replay
                                             (flow/recovery.py); body may be
                                             JSON {"revision": "..."}
    GET    /siddhi-apps/{name}/error-store   stored failed events
                                             (?stream=S filters)
    POST   /siddhi-apps/{name}/error-store/replay
                                             re-inject stored entries; body
                                             may be JSON {"stream": "S",
                                             "ids": [lo, hi]}
    GET    /siddhi-apps/{name}/resilience    sink circuit/retry stats, device
                                             quarantine state, chaos counters
    GET    /siddhi-apps/{name}/dcn           multi-host shard state: peer
                                             health, retry/spill counters,
                                             lane-group ownership, failover
                                             counts (apps with an attached
                                             ``runtime.dcn_worker``)
    GET    /siddhi-apps/{name}/metrics       Prometheus 0.0.4 text exposition
                                             of the app's statistics (tail
                                             buckets carry trace exemplars
                                             when @app:trace sampled one)
    GET    /metrics                          same, across every deployed app
    GET    /siddhi-apps/{name}/trace         sampled pipeline span chains
                                             (@app:trace); ?limit=N caps it,
                                             ?stream=S filters by ingress
                                             stream
    GET    /siddhi-apps/{name}/latency       X-Ray detection-latency
                                             attribution: per-query phase
                                             histograms + end-to-end
                                             reconciliation
    GET    /siddhi-apps/{name}/flightrecorder
                                             control-plane transition ring
                                             (?category=, ?limit=,
                                             ?since_ns= incremental-tail
                                             cursor filters)
    GET    /mesh                             mesh-fabric state (placement
                                             plan, per-host evidence,
                                             migration/recovery counters,
                                             recent decisions) when a
                                             MeshFabric is attached via
                                             ``service.attach_mesh``
    GET    /siddhi-apps/{name}/slo           SLO-autopilot state: per-query
                                             class/budget vs windowed p99,
                                             controller decisions + ladder
                                             position (fleet tenants with
                                             @app:fleet slo.* keys)
    DELETE /siddhi-apps/{name}               undeploy (shutdown + forget)
    POST   /siddhi-apps/{name}/streams/{sid} body = JSON {"data": [...],
                                             "timestamp": ms?} → send event

Responses are JSON ``{"status": "OK"|"ERROR", "message": ...}`` like the
reference's ``ApiResponseMessage``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .core.manager import SiddhiManager


class SiddhiService:
    """Deploy/undeploy SiddhiQL apps over HTTP on a shared manager."""

    def __init__(self, manager: Optional[SiddhiManager] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 playback: bool = False, device=None):
        self.manager = manager or SiddhiManager(device)
        self.playback = playback
        self._lock = threading.Lock()
        self.runtimes: dict[str, object] = {}
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):        # quiet by default
                pass

            def _reply(self, code: int, payload: dict) -> None:
                self._reply_text(code, json.dumps(payload),
                                 "application/json")

            def _reply_text(self, code: int, text: str,
                            content_type: str) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def _wants_openmetrics(self) -> bool:
                # exemplars ride only the OpenMetrics exposition — strict
                # 0.0.4 parsers reject them, so the scraper must ask
                return "application/openmetrics-text" in \
                    (self.headers.get("Accept") or "")

            def _parse_limit(self, query: dict):
                """``?limit=`` → (ok, limit|None); replies 400 itself on a
                malformed value (shared by the ring-paging endpoints)."""
                return self._parse_nonneg(query, "limit")

            def _parse_nonneg(self, query: dict, key: str):
                value = query.get(key)
                try:
                    value = int(value) if value else None
                    if value is not None and value < 0:
                        raise ValueError(value)
                except ValueError:
                    self._reply(400, {
                        "status": "ERROR",
                        "message": f"{key} must be a non-negative integer"})
                    return False, None
                return True, value

            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]
                if parts == ["siddhi-apps"]:
                    code, payload = service.deploy(self._body().decode())
                elif len(parts) == 4 and parts[0] == "siddhi-apps" \
                        and parts[2] == "streams":
                    code, payload = service.send_event(
                        parts[1], parts[3], self._body().decode())
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "recover":
                    code, payload = service.recover(
                        parts[1], self._body().decode())
                elif len(parts) == 4 and parts[0] == "siddhi-apps" \
                        and parts[2:] == ["error-store", "replay"]:
                    code, payload = service.replay_errors(
                        parts[1], self._body().decode())
                else:
                    code, payload = 404, {"status": "ERROR",
                                          "message": "unknown path"}
                self._reply(code, payload)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse
                url = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(url.query).items()}
                parts = [p for p in url.path.split("/") if p]
                if parts == ["siddhi-apps"]:
                    self._reply(200, {"status": "OK",
                                      "apps": sorted(service.runtimes)})
                elif parts == ["mesh"]:
                    code, payload = service.mesh_stats()
                    self._reply(code, payload)
                elif parts == ["mesh", "latency"]:
                    code, payload = service.mesh_latency()
                    self._reply(code, payload)
                elif parts == ["metrics"]:
                    code, text, ctype = service.metrics_text(
                        None, openmetrics=self._wants_openmetrics())
                    self._reply_text(code, text, ctype)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "metrics":
                    code, text, ctype = service.metrics_text(
                        parts[1], openmetrics=self._wants_openmetrics())
                    if code == 200:
                        self._reply_text(code, text, ctype)
                    else:
                        self._reply(code, {"status": "ERROR",
                                           "message": text})
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "trace":
                    ok, limit = self._parse_limit(query)
                    if not ok:
                        return
                    code, payload = service.trace_export(
                        parts[1], limit, query.get("stream"))
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "latency":
                    code, payload = service.latency_stats(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "flightrecorder":
                    ok, limit = self._parse_limit(query)
                    if not ok:
                        return
                    ok, since_ns = self._parse_nonneg(query, "since_ns")
                    if not ok:
                        return
                    code, payload = service.flight_export(
                        parts[1], query.get("category"), limit, since_ns)
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "slo":
                    code, payload = service.slo_stats(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "status":
                    code, payload = service.status(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "flow":
                    code, payload = service.flow_stats(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "error-store":
                    code, payload = service.error_store_entries(
                        parts[1], query.get("stream"))
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "resilience":
                    code, payload = service.resilience_stats(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "dcn":
                    code, payload = service.dcn_stats(parts[1])
                    self._reply(code, payload)
                elif len(parts) == 3 and parts[0] == "siddhi-apps" \
                        and parts[2] == "fleet":
                    code, payload = service.fleet_stats(parts[1])
                    self._reply(code, payload)
                else:
                    self._reply(404, {"status": "ERROR",
                                      "message": "unknown path"})

            def do_DELETE(self):
                parts = [p for p in self.path.split("/") if p]
                if len(parts) == 2 and parts[0] == "siddhi-apps":
                    code, payload = service.undeploy(parts[1])
                    self._reply(code, payload)
                else:
                    self._reply(404, {"status": "ERROR",
                                      "message": "unknown path"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self.mesh = None                # MeshFabric via attach_mesh()

    # -- mesh fabric -----------------------------------------------------------
    def attach_mesh(self, fabric) -> None:
        """Attach a :class:`~siddhi_tpu_torch.mesh.MeshFabric` so ``GET /mesh``
        serves its placement plan, per-host evidence and decision trail
        (the fabric is engine-level, not app-level — one per mesh)."""
        self.mesh = fabric

    def mesh_stats(self) -> tuple[int, dict]:
        if self.mesh is None:
            return 200, {"status": "OK", "enabled": False}
        return 200, {"status": "OK", "enabled": True, **self.mesh.report()}

    def mesh_latency(self) -> tuple[int, dict]:
        """Federated latency breakdown across the process mesh: one pull
        of every live worker's phase histograms, rendered per-worker plus
        the fabric-level merge (``GET /mesh/latency``)."""
        if self.mesh is None:
            return 200, {"status": "OK", "enabled": False}
        try:
            fed = self.mesh.federation()
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            return 500, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", "enabled": True, **fed}

    # -- operations (also usable programmatically) -----------------------------
    def deploy(self, app_text: str) -> tuple[int, dict]:
        with self._lock:
            try:
                from .compiler import parse, update_variables
                parsed = parse(update_variables(
                    app_text, None, self.manager.context.config_manager)
                    if "${" in app_text else app_text)
            except Exception as e:
                return 400, {"status": "ERROR", "message": str(e)}
            # duplicate check BEFORE registering — creating first would clobber
            # the running app's slot in manager.runtimes; an app created
            # programmatically on the shared manager counts as a duplicate too
            if parsed.name() in self.runtimes or \
                    parsed.name() in self.manager.runtimes:
                return 409, {"status": "ERROR",
                             "message": f"app '{parsed.name()}' already deployed"}
            try:
                rt = self.manager.create_siddhi_app_runtime(
                    parsed, playback=self.playback)
            except Exception as e:
                return 400, {"status": "ERROR", "message": str(e)}
            try:
                rt.start()
            except Exception as e:
                self.manager.runtimes.pop(rt.name, None)
                return 500, {"status": "ERROR",
                             "message": f"start failed: {e}"}
            self.runtimes[rt.name] = rt
            return 200, {"status": "OK", "name": rt.name,
                         "message": "Siddhi app deployed and runtime created"}

    def undeploy(self, name: str) -> tuple[int, dict]:
        with self._lock:
            rt = self.runtimes.pop(name, None)
            if rt is None:
                return 404, {"status": "ERROR",
                             "message": f"no app '{name}' deployed"}
            rt.shutdown()
            self.manager.runtimes.pop(name, None)
            return 200, {"status": "OK",
                         "message": "Siddhi app removed successfully"}

    def status(self, name: str) -> tuple[int, dict]:
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        running = getattr(rt, "_started", False)
        return 200, {"status": "OK",
                     "state": "running" if running else "stopped"}

    def send_event(self, name: str, stream_id: str,
                   body: str) -> tuple[int, dict]:
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        try:
            payload = json.loads(body)
            data = payload["data"]
            ts = payload.get("timestamp")
            rt.input_handler(stream_id).send(data, timestamp=ts)
        except Exception as e:
            return 400, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", "message": "event sent"}

    def flow_stats(self, name: str) -> tuple[int, dict]:
        """Flow-control observability: WAL/backpressure stats plus any
        adaptive device batch sizes."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        flow = getattr(rt, "flow", None)
        payload = {"status": "OK"}
        payload.update(flow.stats_report() if flow is not None
                       else {"enabled": False, "streams": {}})
        adaptive = {}
        for bridge in getattr(rt, "device_bridges", []):
            ctrl = getattr(bridge.runtime, "batch_controller", None)
            if ctrl is not None:
                adaptive[bridge.query_name] = ctrl.report()
        if adaptive:
            payload["adaptive"] = adaptive
        return 200, payload

    def error_store_entries(self, name: str,
                            stream: Optional[str] = None) -> tuple[int, dict]:
        """Stored failed events awaiting replay (GET .../error-store)."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        store = rt.ctx.siddhi_context.error_store
        if store is None:
            return 200, {"status": "OK", "entries": []}
        from dataclasses import asdict
        entries = [asdict(e) for e in store.load(name, stream)]
        # event data may hold non-JSON values (OBJECT attributes) — stringify
        for e in entries:
            e["event_data"] = [
                v if isinstance(v, (str, int, float, bool, type(None)))
                else repr(v) for v in e["event_data"]]
        return 200, {"status": "OK", "entries": entries}

    def replay_errors(self, name: str, body: str = "") -> tuple[int, dict]:
        """Re-inject stored entries (POST .../error-store/replay); body may
        narrow by {"stream": "...", "ids": [lo, hi]}."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        store = rt.ctx.siddhi_context.error_store
        if store is None:
            return 400, {"status": "ERROR",
                         "message": "no error store configured"}
        stream = min_id = max_id = None
        if body.strip():
            try:
                payload = json.loads(body)
                stream = payload.get("stream")
                ids = payload.get("ids")
                if ids is not None:
                    min_id, max_id = int(ids[0]), int(ids[1])
            except (ValueError, TypeError, IndexError, AttributeError):
                return 400, {"status": "ERROR",
                             "message": 'body must be JSON like {"stream": '
                                        '"S", "ids": [lo, hi]} or empty'}
        try:
            report = store.replay(rt, stream, min_id, max_id)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            return 500, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", **report}

    def metrics_text(self, name: Optional[str],
                     openmetrics: bool = False) -> tuple[int, str, str]:
        """Prometheus text exposition: one app, or every deployed app when
        ``name`` is None (the all-apps scrape endpoint). Returns
        ``(code, text, content_type)``; with ``openmetrics=True`` the
        exposition carries trace-id exemplars and the ``# EOF`` terminator
        under the OpenMetrics content type."""
        from .observability import CONTENT_TYPE, render
        from .observability.prometheus import OPENMETRICS_CONTENT_TYPE
        ctype = OPENMETRICS_CONTENT_TYPE if openmetrics else CONTENT_TYPE
        if name is None:
            managers = [rt.ctx.statistics_manager
                        for _, rt in sorted(self.runtimes.items())]
        else:
            rt = self.runtimes.get(name)
            if rt is None:
                return 404, f"no app '{name}' deployed", CONTENT_TYPE
            managers = [rt.ctx.statistics_manager]
        collectors = ()
        if name is None and self.mesh is not None \
                and self.mesh.supervisor is not None:
            # federate the process mesh on the all-apps scrape: pull every
            # live worker's tracker state, then render per-worker families
            # plus the fabric merge alongside the parent's own
            try:
                self.mesh.sync_children()
            except Exception:  # noqa: BLE001 — stale caches still render
                pass
            collectors = (self.mesh.collect_federated,)
        text = render(managers, with_exemplars=openmetrics,
                      collectors=collectors)
        if openmetrics:
            text += "# EOF\n"
        return 200, text, ctype

    def trace_export(self, name: str, limit: Optional[int] = None,
                     stream: Optional[str] = None) -> tuple[int, dict]:
        """Sampled span chains from the app's @app:trace ring; ``stream``
        filters by ingress stream so a 2048-deep ring is usable without
        client-side paging."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        return 200, {"status": "OK",
                     **rt.observability.trace_export(limit, stream)}

    def latency_stats(self, name: str) -> tuple[int, dict]:
        """X-Ray detection-latency attribution: per-query per-phase
        percentiles reconciled against the end-to-end histogram."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        return 200, {"status": "OK", **rt.observability.latency_report()}

    def flight_export(self, name: str, category: Optional[str] = None,
                      limit: Optional[int] = None,
                      since_ns: Optional[int] = None) -> tuple[int, dict]:
        """The app's flight-recorder ring: timestamped control-plane
        transitions (AIMD resizes, flush causes, breaker flips, ejections,
        SLO decisions, takeovers), trace-cross-referenced where provoked
        by a traced batch. ``since_ns`` tails the ring incrementally: pass
        the largest ``t_ns`` already seen, only newer entries return."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        return 200, {"status": "OK",
                     **rt.observability.flight_export(category, limit,
                                                      since_ns)}

    def slo_stats(self, name: str) -> tuple[int, dict]:
        """SLO-autopilot state for one tenant app: its queries' declared
        class/budget against the windowed measured p99, plus each attached
        group controller's ladder position and recent decision log."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        queries, controllers, seen = [], [], set()
        for b in getattr(rt, "fleet_bridges", []):
            member = b.member
            group = member.group if member.group is not None else b.group
            t = getattr(member, "slo", None)
            if t is not None:
                queries.append(t.report())
            ctrl = getattr(group, "slo", None)
            if ctrl is not None and id(ctrl) not in seen:
                seen.add(id(ctrl))
                controllers.append(ctrl.report())
        if not queries and not controllers:
            return 200, {"status": "OK", "enabled": False}
        return 200, {"status": "OK", "enabled": True, "queries": queries,
                     "controllers": controllers}

    def resilience_stats(self, name: str) -> tuple[int, dict]:
        """Sink circuits/retries, device quarantine, chaos counters."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        resilience = getattr(rt, "resilience", None)
        payload = {"status": "OK"}
        payload.update(resilience.report() if resilience is not None
                       else {"sinks": [], "device": []})
        return 200, payload

    def dcn_stats(self, name: str) -> tuple[int, dict]:
        """Multi-host shard state (peer health / spill / failover). A
        sharded deployment attaches its DCN worker as
        ``runtime.dcn_worker``; single-host apps report ``enabled:
        false``."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        worker = getattr(rt, "dcn_worker", None)
        if worker is None:
            return 200, {"status": "OK", "enabled": False}
        return 200, {"status": "OK", "enabled": True, **worker.report()}

    def fleet_stats(self, name: str) -> tuple[int, dict]:
        """Fleet-tier guard state for one tenant app: its enrolled lanes
        (with per-tenant ejection/circuit/shed evidence), the shape groups
        it belongs to (guard + fair-share reports), and the engine-wide
        solo-fallback log so quietly degraded fleets are visible."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        bridges = getattr(rt, "fleet_bridges", [])
        if not bridges:
            return 200, {"status": "OK", "enabled": False}
        mgr = self.manager.fleet
        stats = mgr.stats()
        keys = {b.group.shape_key for b in bridges}
        return 200, {
            "status": "OK", "enabled": True,
            "queries": [b.report() for b in bridges],
            "groups": {k: g for k, g in stats["groups"].items()
                       if k in keys},
            "solo_fallbacks": stats["fallbacks"],
            "fallback_reasons": stats["fallback_reasons"],
            "cache": stats["cache"],
        }

    def recover(self, name: str, body: str = "") -> tuple[int, dict]:
        """Restore the latest (or a named) persisted revision and replay the
        WAL suffix — the crash-recovery entry point for deployed apps."""
        rt = self.runtimes.get(name)
        if rt is None:
            return 404, {"status": "ERROR",
                         "message": f"no app '{name}' deployed"}
        revision = None
        if body.strip():
            try:
                revision = json.loads(body).get("revision")
            except (ValueError, AttributeError):
                return 400, {"status": "ERROR",
                             "message": "body must be JSON like "
                                        '{"revision": "..."} or empty'}
        try:
            from .flow.recovery import recover as _recover
            report = _recover(rt, revision)
        except Exception as e:
            return 400, {"status": "ERROR", "message": str(e)}
        return 200, {"status": "OK", **report}

    # -- lifecycle -------------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            for name, rt in list(self.runtimes.items()):
                rt.shutdown()
                self.manager.runtimes.pop(name, None)
            self.runtimes.clear()
