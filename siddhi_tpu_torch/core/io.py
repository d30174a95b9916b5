"""Sources, sinks, mappers, and the in-memory broker.

The port's copy of the JAX package's ``core/io.py`` (reference
``core/stream/input/source/`` (``Source.java`` with connect/retry,
``SourceMapper``), ``core/stream/output/sink/`` (``Sink.java``, ``SinkMapper``,
``LogSink``, ``InMemorySink``), ``core/util/transport/InMemoryBroker.java``).
Transports are host-side by design: they feed the engine's junctions, and a
``@device`` query's micro-batching ingress behind them. The CSV mapper's
rows path parses with ``core/columns.py::CsvColumnParser`` (the native C++
parse of ``native/`` where g++ exists). The port's ``InMemoryBroker`` is a
class of its own: its topics are not the JAX package's.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ..query_api.annotation import Annotation
from ..query_api.definition import DataType, StreamDefinition
from .columns import (
    CsvColumnParser,
    RowsChunk,
    columns_to_rows,
    unpack_columns,
)
from .event import Event, EventType

log = logging.getLogger("siddhi_tpu_torch.io")


# ---------------------------------------------------------------------------
# In-memory broker (static topic pub/sub, test transport)
# ---------------------------------------------------------------------------

class InMemoryBroker:
    _topics: dict[str, list[Callable[[Any], None]]] = {}
    _lock = threading.RLock()

    @classmethod
    def subscribe(cls, topic: str, receiver: Callable[[Any], None]) -> Callable[[], None]:
        with cls._lock:
            cls._topics.setdefault(topic, []).append(receiver)

        def unsubscribe():
            with cls._lock:
                if receiver in cls._topics.get(topic, []):
                    cls._topics[topic].remove(receiver)

        return unsubscribe

    @classmethod
    def publish(cls, topic: str, payload: Any) -> None:
        with cls._lock:
            receivers = list(cls._topics.get(topic, []))
        for r in receivers:
            r(payload)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._topics.clear()


# ---------------------------------------------------------------------------
# Mappers
# ---------------------------------------------------------------------------

class SourceMapper:
    """payload → list of event payload lists.

    Rows-capable mappers additionally implement ``map_rows(payload_bytes)
    -> list[RowsChunk]`` (columns, not rows): the edge then delivers whole
    columnar chunks through ``InputHandler.send_columns`` with zero
    per-event Python objects. Legacy mappers (``map_rows`` left None) keep
    the per-event path unchanged."""

    map_rows = None             # rows-capable mappers override with a method

    def init(self, definition: StreamDefinition, options: dict) -> None:
        self.definition = definition
        self.options = options

    def map(self, payload: Any) -> list[list]:
        raise NotImplementedError


class PassThroughSourceMapper(SourceMapper):
    def map(self, payload: Any) -> list[list]:
        if isinstance(payload, Event):
            return [list(payload.data)]
        if isinstance(payload, (list, tuple)):
            if payload and isinstance(payload[0], (list, tuple, Event)):
                return [list(p.data) if isinstance(p, Event) else list(p)
                        for p in payload]
            return [list(payload)]
        raise ValueError(f"passThrough cannot map {type(payload).__name__}")


class JsonSourceMapper(SourceMapper):
    def map(self, payload: Any) -> list[list]:
        obj = json.loads(payload) if isinstance(payload, (str, bytes)) else payload
        events = obj if isinstance(obj, list) else [obj]
        out = []
        for e in events:
            if isinstance(e, dict):
                body = e.get("event", e)
                out.append([body.get(a.name) for a in self.definition.attributes])
            else:
                out.append(list(e))
        return out


class CsvSourceMapper(SourceMapper):
    """CSV line payloads, both paths:

    - ``map_rows`` (bytes of whole lines) parses straight into columns via
      :class:`~siddhi_tpu_torch.core.columns.CsvColumnParser` — native C++ parse
      + dictionary encode + SoA staging when a toolchain exists, pure
      Python otherwise; ZERO per-event objects either way;
    - ``map`` is the per-event reference path (parity oracle for the rows
      path; also what non-line transports get).

    Options: ``ts.last='true'`` reads a trailing int64 event-time field
    per line; ``parse.capacity`` bounds one staged chunk (default 65536).
    """

    def init(self, definition: StreamDefinition, options: dict) -> None:
        super().init(definition, options)
        self.ts_last = (options.get("ts.last") or "").lower() == "true"
        self._parser: Optional[CsvColumnParser] = None

    @property
    def parser(self) -> CsvColumnParser:
        if self._parser is None:
            self._parser = CsvColumnParser(
                self.definition, ts_last=self.ts_last,
                capacity=int(self.options.get("parse.capacity") or 65536))
        return self._parser

    # -- rows path (zero-object) -----------------------------------------
    def map_rows(self, payload: bytes) -> list[RowsChunk]:
        return self.parser.parse(bytes(payload))

    # -- per-event reference path ----------------------------------------
    def map(self, payload: Any) -> list:
        if isinstance(payload, (bytes, bytearray, memoryview)):
            payload = bytes(payload).decode()
        out = []
        attrs = self.definition.attributes
        expected = len(attrs) + (1 if self.ts_last else 0)
        for line in str(payload).splitlines():
            line = line.strip("\r")
            if not line:
                continue
            fields = line.split(",")
            if len(fields) != expected:
                raise ValueError(
                    f"csv line has {len(fields)} fields, expected "
                    f"{expected}: {line!r}")
            row = []
            for f, a in zip(fields, attrs):
                if a.type == DataType.STRING:
                    row.append(f if f else None)
                elif not f:
                    row.append(None)
                elif a.type in (DataType.INT, DataType.LONG):
                    row.append(int(f))
                elif a.type == DataType.BOOL:
                    row.append(f.lower() == "true" or f == "1")
                else:
                    row.append(float(f))
            if self.ts_last:
                out.append(Event(int(fields[-1]), row))
            else:
                out.append(row)
        return out

    # mapper-level edge stats (wired as source.{sid}.* gauges)
    @property
    def rows_out(self) -> int:
        return self.parser.rows_out if self._parser else 0

    @property
    def rows_per_s(self) -> float:
        return self.parser.rows_per_s if self._parser else 0.0

    @property
    def parse_errors(self) -> int:
        return self.parser.parse_errors if self._parser else 0

    @property
    def parse_seconds(self) -> float:
        return self.parser.parse_seconds if self._parser else 0.0


class JsonLinesSourceMapper(SourceMapper):
    """JSON-lines payloads: ``map_rows`` parses each line once and emits
    ONE columnar chunk (the parse itself allocates transient dicts — only
    a native parser avoids that — but downstream of the mapper the chunk
    is zero-object end to end). ``map`` is the per-event path."""

    def init(self, definition: StreamDefinition, options: dict) -> None:
        super().init(definition, options)
        self.rows_out = 0
        self.parse_errors = 0
        self.parse_seconds = 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows_out / self.parse_seconds if self.parse_seconds \
            else 0.0

    def map_rows(self, payload: bytes) -> list[RowsChunk]:
        t0 = time.perf_counter()
        attrs = self.definition.attributes
        raw: list[list] = [[] for _ in attrs]
        n = 0
        for line in bytes(payload).split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                self.parse_errors += 1
                continue
            body = obj.get("event", obj) if isinstance(obj, dict) else None
            if not isinstance(body, dict):
                self.parse_errors += 1
                continue
            for c, a in zip(raw, attrs):
                c.append(body.get(a.name))
            n += 1
        self.parse_seconds += time.perf_counter() - t0
        self.rows_out += n
        if n == 0:
            return []
        from .columns import _CHAR_NP, TYPE_CHARS
        cols: dict[str, Any] = {}
        for vals, a in zip(raw, attrs):
            if a.type == DataType.STRING:
                arr = np.empty(n, dtype=object)
                arr[:] = vals
                cols[a.name] = arr
            else:
                dt = _CHAR_NP[TYPE_CHARS[a.type]]
                cols[a.name] = np.asarray(
                    [0 if v is None else v for v in vals], dtype=dt)
        return [RowsChunk(cols, None, n)]

    def map(self, payload: Any) -> list[list]:
        obj = json.loads(payload) if isinstance(payload, (str, bytes)) \
            else payload
        events = obj if isinstance(obj, list) else [obj]
        out = []
        for e in events:
            body = e.get("event", e) if isinstance(e, dict) else None
            if body is None:
                out.append(list(e))
            else:
                out.append([body.get(a.name)
                            for a in self.definition.attributes])
        return out


class SinkMapper:
    """Rows-capable sink mappers additionally implement ``map_rows(cols,
    ts, n) -> payload`` so a whole output chunk maps in one call (no
    per-event ``Event`` objects on the egress hot path)."""

    map_rows = None             # rows-capable mappers override with a method

    def init(self, definition: StreamDefinition, options: dict) -> None:
        self.definition = definition
        self.options = options

    def map(self, event: Event) -> Any:
        raise NotImplementedError


class PassThroughSinkMapper(SinkMapper):
    def map(self, event: Event) -> Any:
        return event

    def map_rows(self, cols: dict, ts, n: int) -> Any:
        # the chunk IS the payload: downstream columnar consumers (the
        # in-memory broker → a RowsChunk-aware source) keep batch shape
        return RowsChunk(cols, ts, n)


class JsonSinkMapper(SinkMapper):
    def map(self, event: Event) -> Any:
        # OBJECT attributes (e.g. a fault stream's _error exception) fall
        # back to repr — a mapper must not fail on a representable event
        return json.dumps({
            "event": {a.name: v for a, v in zip(self.definition.attributes, event.data)}
        }, default=repr)

    def map_rows(self, cols: dict, ts, n: int) -> Any:
        # one JSON-lines payload per chunk (formatting is inherently
        # per-row string work, but no engine Event objects are built)
        names = [a.name for a in self.definition.attributes]
        rows = columns_to_rows(cols, names, n)
        return "\n".join(
            json.dumps({"event": dict(zip(names, r))}, default=repr)
            for r in rows)


class TextSinkMapper(SinkMapper):
    def map(self, event: Event) -> Any:
        return ", ".join(
            f"{a.name}:{v}" for a, v in zip(self.definition.attributes, event.data))

    def map_rows(self, cols: dict, ts, n: int) -> Any:
        names = [a.name for a in self.definition.attributes]
        rows = columns_to_rows(cols, names, n)
        return "\n".join(
            ", ".join(f"{nm}:{v}" for nm, v in zip(names, r))
            for r in rows)


SOURCE_MAPPERS = {
    "passThrough": PassThroughSourceMapper,
    "json": JsonSourceMapper,
    "csv": CsvSourceMapper,
    "jsonLines": JsonLinesSourceMapper,
}
SINK_MAPPERS = {
    "passThrough": PassThroughSinkMapper,
    "json": JsonSinkMapper,
    "text": TextSinkMapper,
}


# ---------------------------------------------------------------------------
# Source / Sink SPI
# ---------------------------------------------------------------------------

class ConnectionUnavailableError(Exception):
    pass


# ---------------------------------------------------------------------------
# handler interception SPIs
# ---------------------------------------------------------------------------

class SourceHandler:
    """Optional interception stage between a source's mapped rows and the
    stream's ``InputHandler`` (reference ``stream/input/source/
    SourceHandler.java:44`` — there it wraps the InputHandler with optional
    pre-processing; state rides on the instance here instead of the
    reference's StateHolder ceremony).

    Override :meth:`send_event`; call ``input_handler.send(row)`` to forward
    (possibly transformed), or skip the call to drop the event."""

    def init(self, app_name: str, definition: StreamDefinition,
             element_id: str = None) -> None:
        self.app_name = app_name
        self.definition = definition
        # the registry key is the UNIQUE element id (reference registers by
        # the Source's IdGenerator id, not a name-derived one — two @source
        # annotations on one stream must not collide)
        self.id = element_id or \
            f"{app_name}-{definition.id}-{type(self).__name__}"

    def send_event(self, row, input_handler) -> None:
        input_handler.send(row)


class SourceHandlerManager:
    """Per-engine factory + registry of :class:`SourceHandler` instances
    (reference ``SourceHandlerManager.java:27``). Install via
    ``SiddhiManager.set_source_handler_manager``; one handler is generated
    per wired source."""

    def __init__(self):
        self.registered: dict[str, SourceHandler] = {}

    def generate_source_handler(self, source_type: str) -> SourceHandler:
        raise NotImplementedError

    def register_source_handler(self, element_id: str,
                                handler: SourceHandler) -> None:
        self.registered[element_id] = handler

    def unregister_source_handler(self, element_id: str) -> None:
        self.registered.pop(element_id, None)


class SinkHandler:
    """Optional interception stage between a stream's outgoing events and
    its sink mapper (reference ``stream/output/sink/SinkHandler.java:34``).

    Override :meth:`handle`; call ``callback(event)`` to forward to the
    mapper+transport, or skip the call to drop it."""

    def init(self, app_name: str, definition: StreamDefinition,
             callback: Callable[[Event], None],
             element_id: str = None) -> None:
        self.app_name = app_name
        self.definition = definition
        self.callback = callback
        self.id = element_id or \
            f"{app_name}-{definition.id}-{type(self).__name__}"

    def handle(self, event: Event) -> None:
        self.callback(event)


class SinkHandlerManager:
    """Reference ``SinkHandlerManager.java`` — factory + registry of
    :class:`SinkHandler` instances, installed via
    ``SiddhiManager.set_sink_handler_manager``."""

    def __init__(self):
        self.registered: dict[str, SinkHandler] = {}

    def generate_sink_handler(self) -> SinkHandler:
        raise NotImplementedError

    def register_sink_handler(self, element_id: str,
                              handler: SinkHandler) -> None:
        self.registered[element_id] = handler

    def unregister_sink_handler(self, element_id: str) -> None:
        self.registered.pop(element_id, None)


class Source:
    """Transport-agnostic ingress (reference ``Source.java:50``).

    Subclasses implement connect/disconnect and call ``self.handler(payload)``.
    ``connect_with_retry`` applies capped backoff with decorrelating jitter
    like the reference (``connectWithRetry:155``); delays are configurable
    per source via ``retry.delays='0.1,0.5,1'`` (seconds, csv) and the loop
    aborts promptly when the app starts shutting down (the runtime hands
    every wired source its ``shutdown_signal``)."""

    extension_kind = "source"
    RETRY_DELAYS = [0.1, 0.5, 1.0, 5.0]
    shutdown_signal: Optional[threading.Event] = None   # set by the runtime
    connect_attempts = 0        # cumulative, incl. retries (a climbing
    # count on a running app is a flapping transport)

    def init(self, definition: StreamDefinition, options: dict,
             mapper: SourceMapper, handler: Callable[[Any], None]) -> None:
        self.definition = definition
        self.options = options
        self.mapper = mapper
        self.handler = handler

    def connect(self) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def pause(self) -> None:
        pass

    def resume(self) -> None:
        pass

    def retry_delays(self) -> list[float]:
        raw = (getattr(self, "options", None) or {}).get("retry.delays")
        if not raw:
            return list(self.RETRY_DELAYS)
        delays = [float(x) for x in str(raw).split(",") if x.strip()]
        if any(d < 0 for d in delays):
            raise ValueError(f"retry.delays must be >= 0, got {delays}")
        return delays

    def _aborting(self) -> bool:
        sig = self.shutdown_signal
        return sig is not None and sig.is_set()

    def connect_with_retry(self) -> None:
        for i, delay in enumerate([0.0] + self.retry_delays()):
            if delay:
                # jitter decorrelates a fleet reconnecting after an outage
                wait = delay * (0.5 + random.random() * 0.5)
                sig = self.shutdown_signal
                if sig is not None:
                    sig.wait(wait)
                else:
                    time.sleep(wait)
            if self._aborting():
                log.info("source for stream '%s': connect retry aborted "
                         "(app shutting down)", self.definition.id)
                return
            try:
                self.connect_attempts += 1
                self.connect()
                return
            except ConnectionUnavailableError as e:
                log.warning("source connect failed (attempt %d): %s", i + 1, e)
        raise ConnectionUnavailableError(
            f"source for stream '{self.definition.id}' could not connect")


class InMemorySource(Source):
    def connect(self) -> None:
        topic = self.options.get("topic")
        if topic is None:
            raise ValueError("inMemory source needs topic")
        # a RowsChunk payload published to the topic forwards through the
        # columnar ingress (send_columns) instead of exploding into
        # per-event publishes — the app handler dispatches on payload type
        self._unsub = InMemoryBroker.subscribe(topic, self.handler)

    def disconnect(self) -> None:
        if hasattr(self, "_unsub"):
            self._unsub()


class LineSource(Source):
    """Base for byte-stream transports framed by newlines: buffers torn
    tails across reads, hands ONLY whole lines downstream. With a
    rows-capable mapper the payload goes down as raw bytes (the handler
    parses straight into columns → ``send_columns``, zero per-event
    objects); with a legacy mapper each line maps per event."""

    # torn-tail cap: a peer streaming bytes with no newline must not grow
    # resident memory without bound — past the cap the tail drops (counted)
    MAX_LINE_BYTES = 16 << 20

    def init(self, definition: StreamDefinition, options: dict,
             mapper: SourceMapper, handler: Callable[[Any], None]) -> None:
        super().init(definition, options, mapper, handler)
        self._tail = b""
        self.bytes_in = 0
        self.dropped_bytes = 0
        self._stop = threading.Event()
        self._rows_mapper = callable(getattr(mapper, "map_rows", None))
        self._max_line = int(options.get("max.line.bytes")
                             or self.MAX_LINE_BYTES)

    def feed(self, data: bytes) -> None:
        """One transport read: complete lines flow, the torn tail waits."""
        self.bytes_in += len(data)
        buf = self._tail + data if self._tail else data
        idx = buf.rfind(b"\n")
        if idx < 0:
            if len(buf) > self._max_line:
                self.dropped_bytes += len(buf)
                log.error("source '%s': dropping %d buffered bytes with no "
                          "line terminator (max.line.bytes=%d) — runaway "
                          "or non-line peer", self.definition.id, len(buf),
                          self._max_line)
                buf = b""
            self._tail = buf
            return
        complete, self._tail = buf[:idx + 1], buf[idx + 1:]
        self._dispatch(complete)

    def finish(self) -> None:
        """End of stream: an unterminated final line still counts."""
        if self._tail:
            tail, self._tail = self._tail, b""
            self._dispatch(tail + b"\n")

    def _dispatch(self, payload: bytes) -> None:
        if self._rows_mapper:
            self.handler(payload)
            return
        for line in payload.splitlines():
            if line:
                self.handler(line)

    def _stopping(self) -> bool:
        return self._stop.is_set() or self._aborting()

    def disconnect(self) -> None:
        self._stop.set()


class FileLineSource(LineSource):
    """``@source(type='file', file='/path', @map(type='csv', ...))`` —
    reads the file in chunks on a feeder thread; with a csv rows mapper the
    whole pipeline file-bytes → columns → SoA staging is zero-object."""

    def connect(self) -> None:
        path = self.options.get("file") or self.options.get("path")
        if not path:
            raise ValueError("file source needs file='...'")
        self._stop.clear()
        self.drained = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(path,), daemon=True,
            name=f"file-source-{self.definition.id}")
        self._thread.start()

    def _run(self, path: str) -> None:
        chunk = int(self.options.get("chunk.bytes") or (1 << 20))
        try:
            with open(path, "rb") as f:
                while not self._stopping():
                    data = f.read(chunk)
                    if not data:
                        break
                    self.feed(data)
            if not self._stopping():
                self.finish()
        except OSError as e:
            log.error("file source '%s': %s", path, e)
        finally:
            self.drained.set()

    def wait_drained(self, timeout: float = 30.0) -> bool:
        return self.drained.wait(timeout)

    def disconnect(self) -> None:
        super().disconnect()
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join(timeout=5.0)


class SocketLineSource(LineSource):
    """``@source(type='socket', port='...', format='lines'|'rows')`` — a
    TCP listener parsing raw transport bytes straight into columns.

    ``format='lines'``: newline-framed text (csv/json-lines mappers).
    ``format='rows'``: length-prefixed ``pack_rows`` SoA frames
    (``u32 len`` + payload — the wire format of ``gpu/dcn.py``, which the
    write-ahead log also writes), decoded by ``unpack_columns`` with no
    text parse at all.

    Every blocking socket op is deadlined (``accept.timeout.ms``,
    ``read.timeout.ms``) so shutdown never hangs on a quiet peer."""

    def connect(self) -> None:
        host = self.options.get("host") or "127.0.0.1"
        port = int(self.options.get("port") or 0)
        self.format = (self.options.get("format") or "lines").lower()
        if self.format not in ("lines", "rows"):
            raise ValueError(f"socket source: unknown format "
                             f"'{self.format}' (lines|rows)")
        self._accept_t = float(self.options.get("accept.timeout.ms")
                               or 250) / 1000.0
        self._read_t = float(self.options.get("read.timeout.ms")
                             or 250) / 1000.0
        self._stop.clear()
        try:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((host, port))
            ls.listen(4)
        except OSError as e:
            raise ConnectionUnavailableError(
                f"socket source cannot bind {host}:{port}: {e}") from e
        self._lsock = ls
        self.port = ls.getsockname()[1]     # port=0 → ephemeral, for tests
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"socket-source-{self.definition.id}")
        self._thread.start()

    def _accept_loop(self) -> None:
        ls = self._lsock
        ls.settimeout(self._accept_t)
        while not self._stopping():
            try:
                conn, _addr = ls.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._serve(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(self._read_t)       # every recv below is deadlined
        buf = b""
        while not self._stopping():
            try:
                data = conn.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            if self.format == "lines":
                self.feed(data)
            else:
                buf = self._feed_frames(buf + data)
                if buf is None:         # poisoned frame: drop the peer
                    break
        if self.format == "lines":
            self.finish()

    def _feed_frames(self, buf: bytes):
        """Length-prefixed ``pack_rows`` frames → RowsChunk payloads (the
        zero-object wire path: numeric columns are frombuffer views).
        Returns the unconsumed remainder, or None when a frame claims more
        than ``max.frame.bytes`` (a corrupt/hostile prefix must not make
        the receiver buffer gigabytes) — the caller closes the peer."""
        names = self.definition.attribute_names
        max_frame = int(self.options.get("max.frame.bytes") or (64 << 20))
        while len(buf) >= 4:
            (need,) = struct.unpack_from(">I", buf, 0)
            if need > max_frame:
                self.dropped_bytes += len(buf)
                log.error("socket source '%s': frame claims %d bytes "
                          "(max.frame.bytes=%d) — dropping the connection",
                          self.definition.id, need, max_frame)
                return None
            if len(buf) - 4 < need:
                break
            payload = buf[4:4 + need]
            buf = buf[4 + need:]
            self.bytes_in += need + 4
            try:
                cols_by_pos, ts, n, _types = unpack_columns(payload)
            except (struct.error, ValueError, IndexError) as e:
                log.error("socket source '%s': bad rows frame: %s",
                          self.definition.id, e)
                continue
            if n:
                self.handler(RowsChunk(
                    {nm: cols_by_pos[i] for i, nm in enumerate(names)},
                    ts, n))
        return buf

    def disconnect(self) -> None:
        super().disconnect()
        ls = getattr(self, "_lsock", None)
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join(timeout=5.0)


class PartialPublishError(Exception):
    """A rows-capable sink failed PART-way through a chunk: ``published``
    leading rows made it out; the resilience pipeline replays only the
    remainder per event (exactly-once egress for the chunk)."""

    def __init__(self, published: int, cause: Optional[Exception] = None):
        super().__init__(f"chunk publish failed after {published} row(s)"
                         + (f": {cause}" if cause else ""))
        self.published = int(published)
        self.cause = cause


class Sink:
    extension_kind = "sink"

    # rows-capable sinks override with a method: publish_rows(payload, n)
    # publishes one whole mapped chunk (all-or-nothing, or raise
    # PartialPublishError(published) so the pipeline replays the tail)
    publish_rows = None

    def init(self, definition: StreamDefinition, options: dict,
             mapper: SinkMapper) -> None:
        self.definition = definition
        self.options = options
        self.mapper = mapper

    def connect(self) -> None:
        pass

    def disconnect(self) -> None:
        pass

    def publish(self, payload: Any) -> None:
        raise NotImplementedError

    def on_event(self, event: Event) -> None:
        self.publish(self.mapper.map(event))

    @property
    def rows_capable(self) -> bool:
        """True when both this sink and its mapper handle whole chunks —
        the junction then delivers columns with zero per-event objects."""
        return type(self).publish_rows is not None and \
            callable(getattr(self.mapper, "map_rows", None))

    def on_columns(self, cols: dict, ts, n: int) -> None:
        self.publish_rows(self.mapper.map_rows(cols, ts, n), n)


class InMemorySink(Sink):
    def publish(self, payload: Any) -> None:
        InMemoryBroker.publish(self.options["topic"], payload)

    def publish_rows(self, payload: Any, n: int) -> None:
        InMemoryBroker.publish(self.options["topic"], payload)


class LogSink(Sink):
    def publish(self, payload: Any) -> None:
        prefix = self.options.get("prefix", self.definition.id)
        log.info("%s : %s", prefix, payload)

    def publish_rows(self, payload: Any, n: int) -> None:
        prefix = self.options.get("prefix", self.definition.id)
        log.info("%s : [%d rows] %s", prefix, n, payload)


class SinkReceiver:
    """Direct junction subscription for a wired sink (per-event path)."""

    def __init__(self, sink):
        self.sink = sink

    def receive(self, event) -> None:
        if event.type in (EventType.CURRENT, EventType.EXPIRED):
            self.sink.on_event(Event(event.timestamp, event.data,
                                     event.type == EventType.EXPIRED))


class RowsSinkReceiver(SinkReceiver):
    """Columns-capable sink subscription: whole chunks flow through
    ``Sink.on_columns`` (→ ``SinkMapper.map_rows`` → ``publish_rows``) with
    zero per-event Python objects on the happy path."""

    def receive_columns(self, cols: dict, ts, n: int) -> None:
        self.sink.on_columns(cols, ts, n)


SOURCES = {"inMemory": InMemorySource, "file": FileLineSource,
           "socket": SocketLineSource}
SINKS = {"inMemory": InMemorySink, "log": LogSink}


class DistributionStrategy:
    """Reference: ``stream/output/sink/distributed/DistributionStrategy.java`` —
    picks destination index(es) per event."""

    def __init__(self, destinations: int):
        self.n = destinations

    def destinations_for(self, event: Event) -> list[int]:
        raise NotImplementedError


class RoundRobinStrategy(DistributionStrategy):
    def __init__(self, destinations: int):
        super().__init__(destinations)
        self._i = 0

    def destinations_for(self, event: Event) -> list[int]:
        i = self._i
        self._i = (self._i + 1) % self.n
        return [i]


class PartitionedStrategy(DistributionStrategy):
    def __init__(self, destinations: int, key_pos: int):
        super().__init__(destinations)
        self.key_pos = key_pos

    def destinations_for(self, event: Event) -> list[int]:
        import zlib
        # stable across processes (Python's hash() is randomized) so a key
        # always lands on the same endpoint after restarts
        key = str(event.data[self.key_pos]).encode()
        return [zlib.crc32(key) % self.n]


class BroadcastStrategy(DistributionStrategy):
    def destinations_for(self, event: Event) -> list[int]:
        return list(range(self.n))


class DistributedSink:
    """Multi-endpoint egress (reference ``MultiClientDistributedSink.java``):
    one underlying sink per @destination, events routed per strategy."""

    def __init__(self, sinks: list[Sink], strategy: DistributionStrategy):
        self.sinks = sinks
        self.strategy = strategy

    def on_event(self, event: Event) -> None:
        for i in self.strategy.destinations_for(event):
            self.sinks[i].on_event(event)

    def connect(self) -> None:
        for s in self.sinks:
            s.connect()

    def disconnect(self) -> None:
        for s in self.sinks:
            s.disconnect()


def parse_io_annotations(definition: StreamDefinition):
    """Extract (@source, @sink) configs from a stream definition's annotations."""
    sources, sinks = [], []
    for ann in definition.annotations:
        low = ann.name.lower()
        if low in ("source", "sink"):
            opts = {e.key: e.value for e in ann.elements if e.key}
            map_ann = ann.nested("map")
            map_type = map_ann.get("type") if map_ann else "passThrough"
            # @map's own options (e.g. ts.last for the csv mapper) reach the
            # mapper alongside the transport options
            map_opts = {e.key: e.value for e in map_ann.elements if e.key} \
                if map_ann else {}
            entry = {"type": opts.get("type"), "options": opts,
                     "map": map_type, "map_options": map_opts}
            dist = ann.nested("distribution")
            if dist is not None and low == "sink":
                entry["distribution"] = {
                    "strategy": dist.get("strategy", "roundRobin"),
                    "partitionKey": dist.get("partitionKey"),
                    "destinations": [
                        {e.key: e.value for e in d.elements if e.key}
                        for d in dist.annotations if d.name.lower() == "destination"
                    ],
                }
            (sources if low == "source" else sinks).append(entry)
    return sources, sinks
