# Copied verbatim from kyverno_tpu/fleet/server.py.
"""The localhost peer-protocol endpoint every replica exposes.

Four POST routes, all JSON, all answerable from local state only —
a peer request never triggers compute, compilation, or another remote
call, so the peer protocol cannot amplify load across the fleet:

- ``/fleet/heartbeat``: renew the sender's membership lease; the
  response carries our own view (anti-entropy for URL discovery) and,
  from the leader, the gossiped fleet telemetry rollup.
- ``/fleet/fetch``: look up a batch of content-addressed verdict
  keys in the LOCAL cache; hits are returned checksummed. A key we
  do not hold is simply absent from the response.
- ``/fleet/push``: accept freshly computed columns from a peer.
  Every entry is checksum-verified BEFORE it lands in the local cache
  (a poisoned push is dropped and counted, exactly like a poisoned
  fetch response on the client side).
- ``/fleet/telemetry``: this replica's sealed telemetry snapshot
  (fleet/telemetry.py) — the leader pulls it on the heartbeat
  cadence. Also served on GET for humans and scripts.

Every POST body may carry the caller's trace context in a ``trace``
envelope (injected by ``PeerLink.call``); when present, the handler
runs inside a ``fleet.rpc.*`` child span so a cross-replica exchange
renders as ONE connected trace. An envelope-free request (old peer,
curl) opens no span — untraced traffic stays span-free.

GET ``/fleet/state`` returns the membership/shard/telemetry view
(also exposed as ``/debug/fleet`` on the serving debug router).
"""

from __future__ import annotations

import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Any, Dict

from ..observability.tracing import context_from_wire, global_tracer
from ..resilience.faults import SITE_FLEET_TELEMETRY, global_faults
from .peering import decode_entry, encode_entry

if TYPE_CHECKING:  # pragma: no cover
    from .manager import FleetManager


def _rpc_span(route: str, doc: Dict[str, Any], replica_id: str):
    """Child span for a traced peer RPC, no-op context otherwise. The
    ``trace`` envelope is POPPED so route handlers never see transport
    framing in their payload."""
    ctx = context_from_wire(doc.pop("trace", None)) \
        if isinstance(doc, dict) else None
    if ctx is None:
        return contextlib.nullcontext()
    return global_tracer.span(
        f"fleet.rpc.{route}", parent=ctx, replica=replica_id,
        caller=str(doc.get("replica_id", "")) if isinstance(doc, dict)
        else "")


class FleetPeerServer:
    """ThreadingHTTPServer wrapper bound to 127.0.0.1 — the peer
    protocol is an intra-host (or tunneled) control surface, never an
    internet-facing one."""

    def __init__(self, manager: "FleetManager", port: int = 0):
        mgr = manager

        class _Req(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, doc: Dict[str, Any]) -> None:
                body = (json.dumps(doc) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/fleet/state":
                    self._send(200, mgr.state())
                elif self.path == "/fleet/telemetry":
                    self._send(200, _handle_telemetry(mgr))
                elif self.path == "/healthz":
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    doc = json.loads(self.rfile.read(length))
                except ValueError:
                    self._send(400, {"error": "bad json"})
                    return
                routes = {
                    "/fleet/heartbeat": ("heartbeat", mgr.on_heartbeat),
                    "/fleet/fetch": ("fetch",
                                     lambda d: _handle_fetch(mgr, d)),
                    "/fleet/push": ("push",
                                    lambda d: _handle_push(mgr, d)),
                    "/fleet/telemetry": ("telemetry",
                                         lambda d: _handle_telemetry(mgr)),
                }
                hit = routes.get(self.path)
                if hit is None:
                    self._send(404, {"error": "unknown path"})
                    return
                route, handler = hit
                with _rpc_span(route, doc, mgr.config.replica_id):
                    self._send(200, handler(doc))

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Req)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-peer-server")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _handle_fetch(mgr: "FleetManager", doc: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Local-cache-only lookup of a key batch; capped so one request
    cannot serialize an unbounded response."""
    entries = []
    keys = doc.get("keys") or ()
    for raw in list(keys)[:mgr.config.fetch_max_keys]:
        try:
            key = tuple(raw)
            if len(key) != 3:
                continue
        except TypeError:
            continue
        col = mgr.cache_peek(key)
        if col is not None:
            entries.append(encode_entry(key, col))
    return {"replica_id": mgr.config.replica_id, "entries": entries}


def _handle_push(mgr: "FleetManager", doc: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """Verify-then-store for pushed columns: the receive side runs the
    SAME verification ladder as the fetch client — a peer cannot
    poison us just because it did the pushing."""
    from ..observability.metrics import global_registry as m

    accepted = rejected = 0
    for raw in (doc.get("entries") or ())[:mgr.config.fetch_max_keys]:
        key, col, reason = decode_entry(raw,
                                        expect_rows=mgr.expected_rows())
        if col is None:
            rejected += 1
            m.fleet_peer_rejects.inc({"reason": reason or "decode"})
            continue
        mgr.cache_store(key, col)
        accepted += 1
    if accepted:
        m.fleet_gossip.inc({"outcome": "received"}, value=accepted)
    return {"replica_id": mgr.config.replica_id,
            "accepted": accepted, "rejected": rejected}


def _handle_telemetry(mgr: "FleetManager") -> Dict[str, Any]:
    """This replica's sealed telemetry snapshot. The fault filter sits
    on the OUTGOING doc — a ``fleet.telemetry:corrupt`` chaos rule
    ships a damaged snapshot whose checksum then fails on the puller,
    exercising the aggregator's reject path end to end."""
    return global_faults.corrupt(SITE_FLEET_TELEMETRY,
                                 mgr.telemetry.build())
