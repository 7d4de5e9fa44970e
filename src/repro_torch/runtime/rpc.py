"""Length-prefixed socket control plane for the multi-process cluster
backend (``runtime/node_proc.py``).

Every message is one frame::

    [u32 meta_len][u32 raw_len][meta: UTF-8 JSON][raw bytes]

``meta`` is the request/response envelope (op name, set names, offsets,
checksums, shm frame descriptors); ``raw`` is an optional small byte payload
for callers without arena room.  Page payloads normally bypass this socket
entirely through ``core/shm_arena.py`` — the envelope only carries frame
descriptors.

Pickle is NOT part of the wire format, and this copy of the JAX package's
``runtime/rpc.py`` has no pickle escape hatch at all: a value that is not
JSON raises ``TypeError`` naming its type. ``pickle_fallbacks()`` keeps its
name and now counts the values refused, so the hot paths' zero-fallback
invariant reads the same as in the reference.
"""
from __future__ import annotations

import json
import socket
import struct
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.sanitizer import blocking_region, tracked_lock

_FRAME = struct.Struct("<II")
_MAX_META = 64 << 20  # sanity bound against desynced streams

_counter_lock = tracked_lock("rpc.counters")
_counters = {"messages": 0, "raw_bytes": 0, "pickle_fallbacks": 0}


def pickle_fallbacks() -> int:
    """How many envelope values this process has refused because they are
    not JSON (the reference's pickle fallbacks; the fast-path counter)."""
    with _counter_lock:
        return _counters["pickle_fallbacks"]


def wire_counters() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero the process-global wire counters.  Tests assert *deltas* across
    one operation; without this hook every assertion depends on what ran
    before it in the process (order-dependent flakes)."""
    with _counter_lock:
        for k in _counters:
            _counters[k] = 0


class ConnectionClosed(ConnectionError):
    """Peer hung up (EOF mid-frame) — for a node process, it died."""


class RemoteError(RuntimeError):
    """The remote handler raised; carries its traceback text."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


def _json_default(obj: Any) -> Any:
    # numpy scalars are routine in envelopes (byte counts, epochs)
    item = getattr(obj, "item", None)
    if item is not None:
        try:
            return item()
        except Exception:
            pass
    with _counter_lock:
        _counters["pickle_fallbacks"] += 1
    raise TypeError(f"rpc envelope value of type {type(obj).__name__} is not "
                    f"JSON; the wire carries JSON only")


def _recvall(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed("peer closed the connection")
        buf += chunk
    return bytes(buf)


def send_msg(sock: socket.socket, meta: Dict[str, Any],
             raw: bytes = b"") -> None:
    body = json.dumps(meta, default=_json_default,
                      separators=(",", ":")).encode("utf-8")
    with blocking_region("rpc.send", allow=("rpc.conn",)):
        sock.sendall(_FRAME.pack(len(body), len(raw)) + body + raw)
    with _counter_lock:
        _counters["messages"] += 1
        _counters["raw_bytes"] += len(raw)


def recv_msg(sock: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    with blocking_region("rpc.recv", allow=("rpc.conn",)):
        return _recv_msg(sock)


def _recv_msg(sock: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    meta_len, raw_len = _FRAME.unpack(_recvall(sock, _FRAME.size))
    if meta_len > _MAX_META:
        raise ConnectionError(f"oversized envelope ({meta_len} bytes)")
    meta = json.loads(_recvall(sock, meta_len).decode("utf-8"))
    raw = _recvall(sock, raw_len) if raw_len else b""
    return meta, raw


class RpcConnection:
    """Driver-side request/response endpoint.  One in-flight call per
    connection (per-connection lock); concurrency across *nodes* comes from
    issuing calls on different connections from TransferEngine workers."""

    def __init__(self, sock: socket.socket, timeout_s: float = 60.0):
        self.sock = sock
        self.sock.settimeout(timeout_s)
        self._lock = tracked_lock("rpc.conn")
        self.calls = 0

    def call(self, op: str, raw: bytes = b"",
             **fields: Any) -> Tuple[Dict[str, Any], bytes]:
        meta = {"op": op, **fields}
        # Holding rpc.conn across the round trip is the design: one
        # in-flight call per connection.  blocking_region() at the socket
        # layer allows exactly this lock and no other.
        with self._lock:
            # pangea: allow(R3): rpc.conn exists to serialize this round trip
            send_msg(self.sock, meta, raw)
            # pangea: allow(R3): reply is read on the same serialized round trip
            reply, reply_raw = recv_msg(self.sock)
            self.calls += 1
        if not reply.get("ok", False):
            raise RemoteError(reply.get("error", "remote handler failed"),
                              reply.get("traceback", ""))
        return reply, reply_raw

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:  # pragma: no cover
            pass


def serve_connection(sock: socket.socket,
                     handlers: Dict[str, Callable[[Dict[str, Any], bytes],
                                                  Optional[Tuple[Dict[str, Any],
                                                                 bytes]]]],
                     on_request: Optional[Callable[[Dict[str, Any]], None]]
                     = None) -> None:
    """Node-process main loop: dispatch envelopes to ``handlers[op]`` until
    the peer hangs up or a handler for ``close`` runs.  Handler errors are
    reported to the caller, never fatal to the loop."""
    while True:
        try:
            meta, raw = recv_msg(sock)
        except (ConnectionClosed, OSError):
            return
        op = meta.get("op", "")
        reply: Dict[str, Any]
        reply_raw = b""
        try:
            if on_request is not None:
                on_request(meta)
            handler = handlers.get(op)
            if handler is None:
                raise KeyError(f"unknown rpc op {op!r}")
            out = handler(meta, raw)
            if out is None:
                reply = {}
            elif isinstance(out, tuple):
                reply, reply_raw = out
            else:
                reply = out
            reply.setdefault("ok", True)
        except Exception as exc:  # noqa: BLE001 - report to caller
            reply = {"ok": False,
                     "error": f"{type(exc).__name__}: {exc}",
                     "traceback": traceback.format_exc()}
            reply_raw = b""
        try:
            try:
                send_msg(sock, reply, reply_raw)
            except TypeError as exc:   # a reply value that is not JSON
                send_msg(sock, {"ok": False,
                                "error": f"TypeError: {exc}",
                                "traceback": traceback.format_exc()})
        except OSError:
            return
        if op == "close":
            return
