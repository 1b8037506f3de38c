"""S3-style remote object store over an HTTP-like transport (Check-N-Run §3).

Check-N-Run's industrial deployment writes checkpoints to *remote* object
storage, where the failure model is lost connections, slow requests and
eventual visibility — not local-disk power loss. This module provides:

  * :class:`Transport` — the minimal HTTP-shaped contract (``request`` →
    :class:`Response`): everything above it is backend-agnostic.
  * :class:`ServerTransport` — reference server semantics over any
    :class:`~repro_torch.core.storage.ObjectStore` backing: single-shot PUT with
    checksum verification, idempotent multipart upload (deterministic
    client-supplied uploadId), list, HEAD, DELETE. Used in-process by
    tests and wrapped by ``repro_torch.core.object_server`` for real HTTP.
  * :class:`RemoteObjectStore` — the client: implements the ``ObjectStore``
    surface with a bounded connection pool, per-request timeouts,
    capped-exponential retry with jitter, a retryable/fatal error taxonomy
    (timeout, 5xx, connection reset → retry; 4xx, checksum mismatch →
    fatal), multipart for blobs above ``part_size``, and a write-through
    read-after-write verify on vote/manifest namespaces — the visibility
    contract ``poll_votes_and_commit`` and ``commit_once`` lean on.
  * :class:`FaultyTransport` — deterministic seeded fault injection
    (error rate with request-lost/response-lost halves, slow-request
    latency tail, fail-after-N-bytes partial puts, visibility lag on
    list) so every protocol point can be tortured reproducibly.
  * :class:`ThrottledTransport` — the :class:`~repro_torch.core.storage.LinkModel`
    bandwidth arithmetic applied at the transport layer, so the
    write-bandwidth benchmark story carries over AND retransmitted bytes
    pay for link time (retry amplification is measurable, not free).
  * :func:`make_store` — URI factory (``http://host:port``, ``mem://``,
    ``file:///path`` or a bare path) shared by the CLI, the host worker
    and the benchmarks.

Idempotency story (why retries can never tear state): keys are immutable,
single-shot PUTs carry a declared crc32 the server verifies before making
the blob visible, and multipart uploadIds are derived from
``(crc32, length)`` so a duplicate initiate/part/complete — including a
"response lost" retry of a complete that already applied — lands on the
same upload state and re-asserts the same bytes. A partial upload (client
died or connection cut mid-body) fails the declared-checksum test and is
discarded server-side, never visible.
"""

from __future__ import annotations

import json
import random
import threading
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple
from urllib.parse import quote, unquote, urlsplit

from .storage import (InMemoryStore, LinkModel, LocalFSStore, ObjectStore,
                      host_link, run_parallel)

OBJ_PATH = "/o/"
MPU_PATH = "/mpu/"
LIST_PATH = "/list"


# --------------------------------------------------------------------------
# error taxonomy
# --------------------------------------------------------------------------
class RemoteStoreError(IOError):
    """Base for every remote-store failure."""


class TransientTransportError(RemoteStoreError):
    """Retryable: the request may not have been applied (or was applied but
    the response was lost) — safe to retry because every operation the
    client issues is idempotent."""


class TransportTimeout(TransientTransportError):
    """The per-request timeout elapsed."""


class TransportConnectionReset(TransientTransportError):
    """The connection dropped mid-request/response."""


class ServerBusyError(TransientTransportError):
    """A 5xx / 429 response — the server-side flavour of transient."""


class FatalTransportError(RemoteStoreError):
    """Non-retryable: a 4xx the client caused, or corrupted data."""


class ChecksumMismatchError(FatalTransportError):
    """Bytes on the wire do not match their declared/expected crc32."""


class RemoteVerifyError(FatalTransportError):
    """Write-through verify failed: a vote/manifest put is either not
    visible after retries or reads back with diverging bytes."""


class RetriesExhaustedError(RemoteStoreError):
    """Every attempt failed with a transient error; the last one is
    chained as ``__cause__``."""


class Response:
    """An HTTP-shaped response: status code, body bytes, header map
    (lower-cased keys)."""

    __slots__ = ("status", "body", "headers")

    def __init__(self, status: int, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = int(status)
        self.body = bytes(body)
        self.headers = dict(headers or {})

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Response({self.status}, {len(self.body)}B, {self.headers})"


class Transport:
    """The wire contract: one synchronous request/response exchange.

    ``params`` become the query string over real HTTP; ``timeout_s`` is a
    per-request bound the transport must enforce (raising
    :class:`TransportTimeout`). Network-level failures surface as
    :class:`TransientTransportError` subclasses; server-level outcomes as
    :class:`Response` status codes.
    """

    def request(self, method: str, path: str, body: bytes = b"",
                params: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None) -> Response:
        raise NotImplementedError


def _crc_hex(data: bytes) -> str:
    return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def obj_path(key: str) -> str:
    return OBJ_PATH + quote(key, safe="/")


def mpu_path(key: str) -> str:
    return MPU_PATH + quote(key, safe="/")


# --------------------------------------------------------------------------
# reference server semantics
# --------------------------------------------------------------------------
class ServerTransport(Transport):
    """Server-side request handling over an :class:`ObjectStore` backing —
    usable directly as an in-process transport, and the single source of
    truth ``object_server`` shims real HTTP onto (so in-process tests and
    multi-pod runs exercise identical semantics).

    Multipart state lives in memory keyed ``(key, uploadId)``; part puts
    auto-create the upload (deterministic ids make that idempotent), and a
    complete that arrives after its state was reaped succeeds iff the
    assembled object already exists with the declared crc — the
    "duplicate delivery" path a retried commit takes.
    """

    def __init__(self, backing: Optional[ObjectStore] = None) -> None:
        self.backing = backing if backing is not None else InMemoryStore()
        self._uploads: Dict[Tuple[str, str], Dict[int, bytes]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- dispatch
    def request(self, method: str, path: str, body: bytes = b"",
                params: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None) -> Response:
        params = params or {}
        if path == LIST_PATH and method == "GET":
            keys = "\n".join(self.backing.list(params.get("prefix", "")))
            return Response(200, keys.encode("utf-8"))
        if path.startswith(OBJ_PATH):
            return self._obj(method, unquote(path[len(OBJ_PATH):]),
                             body, params)
        if path.startswith(MPU_PATH):
            return self._mpu(method, unquote(path[len(MPU_PATH):]),
                             body, params)
        return Response(400, f"bad path: {path}".encode())

    def _obj(self, method: str, key: str, body: bytes,
             params: Dict[str, str]) -> Response:
        if method == "PUT":
            actual = _crc_hex(body)
            declared = params.get("crc")
            if declared is not None and declared != actual:
                # the partial/corrupted upload never becomes visible
                return Response(400, b"checksum mismatch", {"etag": actual})
            self.backing.put(key, body)
            return Response(200, b"", {"etag": actual})
        if method == "GET":
            try:
                data = self.backing.get(key)
            except (KeyError, FileNotFoundError):
                return Response(404, b"no such key")
            return Response(200, data, {"etag": _crc_hex(data)})
        if method == "HEAD":
            if not self.backing.exists(key):
                return Response(404)
            return Response(200, b"",
                            {"content-length": str(self.backing.size(key))})
        if method == "DELETE":
            self.backing.delete(key)
            return Response(204)
        return Response(400, f"bad method {method} for object".encode())

    def _mpu(self, method: str, key: str, body: bytes,
             params: Dict[str, str]) -> Response:
        uid = params.get("uploadId", "")
        if not uid:
            return Response(400, b"missing uploadId")
        if method == "PUT":
            try:
                part = int(params["part"])
            except (KeyError, ValueError):
                return Response(400, b"bad part index")
            actual = _crc_hex(body)
            declared = params.get("crc")
            if declared is not None and declared != actual:
                return Response(400, b"part checksum mismatch",
                                {"etag": actual})
            with self._lock:
                self._uploads.setdefault((key, uid), {})[part] = bytes(body)
            return Response(200, b"", {"etag": actual})
        if method != "POST":
            return Response(400, f"bad method {method} for mpu".encode())
        action = params.get("action", "")
        if action == "initiate":
            with self._lock:
                self._uploads.setdefault((key, uid), {})
            return Response(200)
        if action == "abort":
            with self._lock:
                self._uploads.pop((key, uid), None)
            return Response(204)
        if action == "complete":
            return self._complete(key, uid, body, params)
        return Response(400, f"bad mpu action: {action}".encode())

    def _complete(self, key: str, uid: str, body: bytes,
                  params: Dict[str, str]) -> Response:
        declared = params.get("crc")
        try:
            want = [(int(p), str(e)) for p, e in json.loads(body)["parts"]]
        except (ValueError, KeyError, TypeError):
            return Response(400, b"bad complete body")
        with self._lock:
            state = self._uploads.get((key, uid))
            if state is not None:
                state = dict(state)
        if state is None:
            # duplicate complete after the first one applied and reaped the
            # upload state: succeed iff the object is already there with
            # the right bytes — idempotent under response-lost retries
            try:
                existing = self.backing.get(key)
            except (KeyError, FileNotFoundError):
                return Response(409, b"unknown upload and no object")
            if declared is not None and _crc_hex(existing) != declared:
                return Response(409, b"object exists with different crc")
            return Response(200, b"", {"etag": _crc_hex(existing)})
        missing = [p for p, _ in want if p not in state]
        if missing:
            return Response(409, f"missing parts: {missing}".encode())
        for p, etag in want:
            if _crc_hex(state[p]) != etag:
                return Response(409, f"part {p} etag mismatch".encode())
        blob = b"".join(state[p] for p, _ in sorted(want))
        actual = _crc_hex(blob)
        if declared is not None and actual != declared:
            return Response(409, b"assembled object crc mismatch")
        self.backing.put(key, blob)
        with self._lock:
            self._uploads.pop((key, uid), None)
        return Response(200, b"", {"etag": actual})


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------
class FaultSpec:
    """Seeded fault profile for :class:`FaultyTransport`. Parses from /
    renders to the ``k=v,k=v`` string the host-worker CLI ships across
    process boundaries."""

    FIELDS = ("seed", "error_rate", "partial_put_rate", "slow_rate",
              "slow_s", "list_lag")

    def __init__(self, seed: int = 0, error_rate: float = 0.0,
                 partial_put_rate: float = 0.0, slow_rate: float = 0.0,
                 slow_s: float = 0.02, list_lag: int = 0) -> None:
        self.seed = int(seed)
        self.error_rate = float(error_rate)
        self.partial_put_rate = float(partial_put_rate)
        self.slow_rate = float(slow_rate)
        self.slow_s = float(slow_s)
        self.list_lag = int(list_lag)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        kw: Dict[str, float] = {}
        for item in text.split(","):
            item = item.strip()
            if not item:
                continue
            name, _, val = item.partition("=")
            if name not in cls.FIELDS:
                raise ValueError(f"unknown fault field: {name!r}")
            kw[name] = float(val)
        return cls(**kw)

    def to_arg(self) -> str:
        return ",".join(f"{n}={getattr(self, n)}" for n in self.FIELDS)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FaultSpec({self.to_arg()})"


class FaultyTransport(Transport):
    """Deterministic seeded fault injection around any transport.

    Every decision hashes ``(seed, method, path, attempt#)`` — attempt
    counters are per ``(method, path)`` — so a given request sequence
    fails identically across runs regardless of thread interleaving, and
    a retry of the same request draws a FRESH decision (otherwise a faulted
    request would fail forever and retry could never succeed).

    Injected faults:
      * connection reset at ``error_rate`` — half the resets drop the
        request before delivery, half deliver it and lose the response
        (the case that makes idempotency mandatory);
      * partial puts at ``partial_put_rate`` — the body is truncated at a
        hash-derived offset, delivered, and the connection reset; the
        server's declared-checksum test keeps the fragment invisible;
      * a slow tail at ``slow_rate`` — the request stalls ``slow_s``; if
        that exceeds the caller's ``timeout_s`` budget it surfaces as a
        :class:`TransportTimeout` instead (exercising timeout
        classification);
      * list visibility lag — keys put while lag is configured are hidden
        from the next ``list_lag`` list responses, modelling
        eventually-consistent LIST-after-PUT.
    """

    def __init__(self, inner: Transport, spec: FaultSpec) -> None:
        self.inner = inner
        self.spec = spec
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._list_epoch = 0
        self._visible_from: Dict[str, int] = {}
        self.injected = 0  # total faults fired (observability for tests)

    def _draw(self, method: str, path: str) -> Tuple[int, float, float]:
        with self._lock:
            n = self._counts.get((method, path), 0)
            self._counts[(method, path)] = n + 1
        h = zlib.crc32(f"{self.spec.seed}:{method}:{path}:{n}".encode())
        h &= 0xFFFFFFFF
        # two independent uniforms from disjoint bit ranges
        return h, (h >> 8) / float(1 << 24), (h & 0xFF) / 256.0

    def _note_put(self, method: str, path: str,
                  params: Dict[str, str]) -> None:
        if not self.spec.list_lag:
            return
        key = None
        if method == "PUT" and path.startswith(OBJ_PATH):
            key = unquote(path[len(OBJ_PATH):])
        elif (method == "POST" and path.startswith(MPU_PATH)
                and params.get("action") == "complete"):
            key = unquote(path[len(MPU_PATH):])
        if key is not None:
            with self._lock:
                self._visible_from.setdefault(
                    key, self._list_epoch + self.spec.list_lag)

    def request(self, method: str, path: str, body: bytes = b"",
                params: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None) -> Response:
        params = params or {}
        s = self.spec
        h, r_err, r_slow = self._draw(method, path)
        if s.slow_rate and r_slow < s.slow_rate:
            if timeout_s is not None and s.slow_s >= timeout_s:
                self.injected += 1
                time.sleep(min(timeout_s, 0.05))
                raise TransportTimeout(
                    f"{method} {path}: injected slow request "
                    f"({s.slow_s}s > {timeout_s}s budget)")
            time.sleep(s.slow_s)
        if s.error_rate and r_err < s.error_rate:
            self.injected += 1
            if h & 1:  # deliver, then lose the response
                try:
                    self.inner.request(method, path, body=body,
                                       params=params, timeout_s=timeout_s)
                    self._note_put(method, path, params)
                except RemoteStoreError:
                    pass
                raise TransportConnectionReset(
                    f"{method} {path}: injected reset (response lost)")
            raise TransportConnectionReset(
                f"{method} {path}: injected reset (request lost)")
        if (s.partial_put_rate and method == "PUT" and body
                and r_err < s.error_rate + s.partial_put_rate):
            self.injected += 1
            cut = h % len(body)
            try:
                self.inner.request(method, path, body=body[:cut],
                                   params=params, timeout_s=timeout_s)
            except RemoteStoreError:
                pass
            raise TransportConnectionReset(
                f"{method} {path}: injected partial put "
                f"({cut}/{len(body)} bytes)")
        resp = self.inner.request(method, path, body=body, params=params,
                                  timeout_s=timeout_s)
        if resp.status < 400:
            self._note_put(method, path, params)
        if (s.list_lag and method == "GET" and path == LIST_PATH
                and resp.status == 200):
            with self._lock:
                self._list_epoch += 1
                epoch = self._list_epoch
                hidden = {k for k, vis in self._visible_from.items()
                          if vis >= epoch}
            if hidden:
                keys = [k for k in resp.body.decode("utf-8").splitlines()
                        if k not in hidden]
                resp = Response(200, "\n".join(keys).encode("utf-8"),
                                resp.headers)
        return resp


class ThrottledTransport(Transport):
    """Bandwidth-capped transport: request bodies reserve uplink time,
    response bodies downlink time, on :class:`LinkModel` timelines — the
    same arithmetic :class:`~repro_torch.core.storage.ThrottledStore` uses, so
    benchmark numbers are comparable. Because EVERY attempt pays for its
    bytes, retransmissions from the retry loop consume real link time:
    retry amplification is visible in wall-clock, not hidden."""

    def __init__(self, inner: Transport, write_bytes_per_sec: float,
                 read_bytes_per_sec: Optional[float] = None,
                 num_links: int = 1,
                 link_of: Optional[Callable[[str], int]] = None,
                 cancel_event: Optional[threading.Event] = None) -> None:
        self.inner = inner
        self.num_links = max(1, num_links)
        self.link_of = link_of or host_link
        self.cancel_event = cancel_event or threading.Event()
        self._uplink = LinkModel(write_bytes_per_sec, self.num_links,
                                 self.cancel_event)
        self._downlink = (LinkModel(read_bytes_per_sec, self.num_links,
                                    self.cancel_event)
                          if read_bytes_per_sec else None)

    def request(self, method: str, path: str, body: bytes = b"",
                params: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None) -> Response:
        link = self.link_of(unquote(path)) % self.num_links
        if body:
            self._uplink.transmit(len(body), link, path)
        resp = self.inner.request(method, path, body=body, params=params,
                                  timeout_s=timeout_s)
        if self._downlink is not None and resp.body:
            self._downlink.transmit(len(resp.body), link, path)
        return resp


# --------------------------------------------------------------------------
# HTTP client transport (stdlib http.client; no new dependencies)
# --------------------------------------------------------------------------
class HttpTransport(Transport):
    """Pooled keep-alive HTTP/1.1 client over ``http.client``. Connections
    are reused across requests (bounded pool); a connection that faults is
    closed, not returned. Socket timeouts surface as
    :class:`TransportTimeout`; resets/protocol errors as
    :class:`TransportConnectionReset` — the retryable taxonomy."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 pool_size: int = 8) -> None:
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.pool_size = int(pool_size)
        self._pool: List[object] = []
        self._lock = threading.Lock()

    def _acquire(self, timeout_s: float):
        import http.client
        with self._lock:
            if self._pool:
                conn = self._pool.pop()
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
                return conn
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)

    def _release(self, conn) -> None:
        with self._lock:
            if len(self._pool) < self.pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def request(self, method: str, path: str, body: bytes = b"",
                params: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None) -> Response:
        import http.client
        from urllib.parse import urlencode
        budget = timeout_s if timeout_s is not None else self.timeout_s
        q = urlencode(params or {})
        target = path + (f"?{q}" if q else "")
        conn = self._acquire(budget)
        try:
            conn.request(method, target, body=body)
            r = conn.getresponse()
            data = r.read()
            headers = {k.lower(): v for k, v in r.getheaders()}
        except (TimeoutError, OSError, http.client.HTTPException) as e:
            conn.close()
            if isinstance(e, TimeoutError) or "timed out" in str(e):
                raise TransportTimeout(f"{method} {target}: {e}") from e
            raise TransportConnectionReset(f"{method} {target}: {e}") from e
        self._release(conn)
        return Response(r.status, data, headers)

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()


# --------------------------------------------------------------------------
# retry policy + wire-level stats
# --------------------------------------------------------------------------
class RetryPolicy:
    """Capped exponential backoff with jitter:
    ``delay(n) = min(cap, base·2^(n-1)) · (1 + jitter·U)``, ``attempts``
    total tries. With the defaults, 8 attempts survive a 20% transient
    error rate with failure probability 0.2^8 ≈ 2.6e-6 per operation."""

    def __init__(self, attempts: int = 8, base_s: float = 0.02,
                 cap_s: float = 1.0, jitter: float = 0.25,
                 seed: int = 0) -> None:
        self.attempts = max(1, int(attempts))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        d = min(self.cap_s, self.base_s * (2.0 ** (attempt - 1)))
        if self.jitter <= 0:
            return d
        with self._lock:
            u = self._rng.random()
        return d * (1.0 + self.jitter * u)


class RemoteStats:
    """Wire-level accounting, distinct from the logical
    :class:`~repro_torch.core.storage.StoreCounters`: ``bytes_sent`` counts every
    attempt's request body INCLUDING retransmissions, so
    ``bytes_sent / counters.bytes_written`` is the write-path retry
    amplification the benchmark reports."""

    def __init__(self) -> None:
        self.requests = 0
        self.retries = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.verify_gets = 0
        self._lock = threading.Lock()

    def on_attempt(self, body_len: int) -> None:
        with self._lock:
            self.requests += 1
            self.bytes_sent += body_len

    def on_response(self, body_len: int) -> None:
        with self._lock:
            self.bytes_received += body_len

    def on_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def on_verify(self) -> None:
        with self._lock:
            self.verify_gets += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(requests=self.requests, retries=self.retries,
                        bytes_sent=self.bytes_sent,
                        bytes_received=self.bytes_received,
                        verify_gets=self.verify_gets)

    def write_amplification(self, logical_bytes: int) -> float:
        with self._lock:
            sent = self.bytes_sent
        return sent / logical_bytes if logical_bytes else 0.0


# --------------------------------------------------------------------------
# the client store
# --------------------------------------------------------------------------
class RemoteObjectStore(ObjectStore):
    """The full ``ObjectStore`` surface over a :class:`Transport`.

    * Blobs larger than ``part_size`` go through idempotent multipart
      upload (uploadId derived from content crc+length, so retries and
      duplicate deliveries converge on identical state).
    * A bounded semaphore caps concurrent in-flight requests (the
      "connection pool"); each request carries ``timeout_s``.
    * Transient failures (timeout / reset / 5xx / 429) retry under
      ``retry``; 4xx and checksum mismatches are fatal immediately;
      exhausted retries raise :class:`RetriesExhaustedError` with the last
      transient chained.
    * Puts under ``verify_prefixes`` (votes + manifests — the keys the
      two-phase commit's correctness leans on) are read back and
      byte-compared before the put returns: the explicit read-after-write
      visibility contract. Divergent readback raises
      :class:`RemoteVerifyError` — the caller (``commit_once``) treats
      that as a commit race.
    """

    def __init__(self, transport: Transport, uri: str = "remote://",
                 part_size: int = 8 << 20,
                 retry: Optional[RetryPolicy] = None,
                 max_connections: int = 8, timeout_s: float = 30.0,
                 verify_prefixes: Tuple[str, ...] = ("parts/",
                                                     "manifests/"),
                 part_workers: int = 4) -> None:
        super().__init__()
        self.transport = transport
        self.uri = uri
        self.part_size = int(part_size)
        self.retry = retry or RetryPolicy()
        self.timeout_s = float(timeout_s)
        self.verify_prefixes = tuple(verify_prefixes)
        self.part_workers = int(part_workers)
        self.stats = RemoteStats()
        self._gate = threading.BoundedSemaphore(max(1, int(max_connections)))

    # ------------------------------------------------------------ transport
    def _send(self, method: str, path: str, body: bytes = b"",
              params: Optional[Dict[str, str]] = None,
              ok: Tuple[int, ...] = (200, 204),
              allow: Tuple[int, ...] = ()) -> Response:
        """One logical request: retries transients with backoff, returns
        on ``ok``/``allow`` statuses, raises fatal on other 4xx."""
        last: Optional[Exception] = None
        for attempt in range(1, self.retry.attempts + 1):
            try:
                with self._gate:
                    self.stats.on_attempt(len(body))
                    resp = self.transport.request(
                        method, path, body=body, params=params,
                        timeout_s=self.timeout_s)
                self.stats.on_response(len(resp.body))
            except TransientTransportError as e:
                last = e
            else:
                if resp.status in ok or resp.status in allow:
                    return resp
                if resp.status >= 500 or resp.status == 429:
                    last = ServerBusyError(
                        f"{method} {path} -> {resp.status}")
                else:
                    raise FatalTransportError(
                        f"{method} {path} -> {resp.status}: "
                        f"{resp.body[:200]!r}")
            if attempt < self.retry.attempts:
                self.stats.on_retry()
                time.sleep(self.retry.backoff(attempt))
        raise RetriesExhaustedError(
            f"{method} {path}: all {self.retry.attempts} attempts "
            f"failed transiently") from last

    # ------------------------------------------------------------- puts
    def put(self, key: str, data: bytes) -> None:
        data = bytes(data)
        crc = _crc_hex(data)
        if len(data) > self.part_size:
            self._put_multipart(key, data, crc)
        else:
            resp = self._send("PUT", obj_path(key), body=data,
                              params={"crc": crc})
            etag = resp.headers.get("etag")
            if etag is not None and etag != crc:
                raise ChecksumMismatchError(
                    f"put {key}: server etag {etag} != {crc}")
        if key.startswith(self.verify_prefixes):
            self._verify_visible(key, data)
        self.counters.on_put(len(data))

    def _put_multipart(self, key: str, data: bytes, crc: str) -> None:
        uid = f"{crc}-{len(data)}"
        path = mpu_path(key)
        self._send("POST", path,
                   params={"uploadId": uid, "action": "initiate"})
        chunks = [(i // self.part_size + 1, data[i:i + self.part_size])
                  for i in range(0, len(data), self.part_size)]

        def upload(idx: int, blob: bytes) -> List:
            pcrc = _crc_hex(blob)
            resp = self._send("PUT", path, body=blob,
                              params={"uploadId": uid, "part": str(idx),
                                      "crc": pcrc})
            etag = resp.headers.get("etag", pcrc)
            if etag != pcrc:
                raise ChecksumMismatchError(
                    f"part {idx} of {key}: etag {etag} != {pcrc}")
            return [idx, etag]

        etags = run_parallel(
            [lambda i=i, b=b: upload(i, b) for i, b in chunks],
            self.part_workers, "mpu-part")
        body = json.dumps({"parts": etags}).encode("utf-8")
        self._send("POST", path, body=body,
                   params={"uploadId": uid, "action": "complete",
                           "crc": crc})

    def _verify_visible(self, key: str, data: bytes) -> None:
        """Read-after-write contract on vote/manifest namespaces: the put
        does not return until the key reads back byte-identical."""
        self.stats.on_verify()
        for attempt in range(1, self.retry.attempts + 1):
            resp = self._send("GET", obj_path(key), allow=(404,))
            if resp.status == 200:
                if resp.body == data:
                    return
                raise RemoteVerifyError(
                    f"write-through verify: {key} reads back "
                    f"{len(resp.body)}B crc={_crc_hex(resp.body)}, wrote "
                    f"{len(data)}B crc={_crc_hex(data)}")
            if attempt < self.retry.attempts:
                time.sleep(self.retry.backoff(attempt))
        raise RemoteVerifyError(
            f"write-through verify: {key} not visible after "
            f"{self.retry.attempts} readbacks")

    # ------------------------------------------------------------- reads
    def get(self, key: str) -> bytes:
        resp = self._send("GET", obj_path(key), allow=(404,))
        if resp.status == 404:
            raise KeyError(key)
        etag = resp.headers.get("etag")
        if etag is not None and etag != _crc_hex(resp.body):
            raise ChecksumMismatchError(
                f"get {key}: body crc {_crc_hex(resp.body)} != etag {etag}")
        self.counters.on_get(len(resp.body))
        return resp.body

    def delete(self, key: str) -> None:
        self._send("DELETE", obj_path(key), allow=(404,))
        self.counters.on_delete()

    def list(self, prefix: str = "") -> Iterable[str]:
        resp = self._send("GET", LIST_PATH, params={"prefix": prefix})
        text = resp.body.decode("utf-8")
        return sorted(k for k in text.splitlines() if k)

    def exists(self, key: str) -> bool:
        resp = self._send("HEAD", obj_path(key), allow=(404,))
        return resp.status == 200

    def size(self, key: str) -> int:
        resp = self._send("HEAD", obj_path(key), allow=(404,))
        if resp.status == 404:
            raise KeyError(key)
        return int(resp.headers.get("content-length", "0"))


# --------------------------------------------------------------------------
# URI factory
# --------------------------------------------------------------------------
def make_store(uri: str, part_size: int = 8 << 20,
               retry: Optional[RetryPolicy] = None,
               timeout_s: float = 30.0, max_connections: int = 8,
               batch_fsync: bool = False) -> ObjectStore:
    """Build a store from a URI — the one spelling shared by the CLI, the
    multi-pod host worker and the benchmarks:

      * ``http://host:port``  → :class:`RemoteObjectStore` over
        :class:`HttpTransport` (an ``object_server`` endpoint);
      * ``mem://``            → :class:`RemoteObjectStore` over an
        in-process :class:`ServerTransport` (tests/benchmarks);
      * ``file:///path`` or a bare path → :class:`LocalFSStore`.
    """
    if uri.startswith("http://"):
        parts = urlsplit(uri)
        if not parts.hostname or not parts.port:
            raise ValueError(f"http store URI needs host:port, got {uri!r}")
        transport: Transport = HttpTransport(parts.hostname, parts.port,
                                             timeout_s=timeout_s)
        return RemoteObjectStore(transport, uri=uri, part_size=part_size,
                                 retry=retry, timeout_s=timeout_s,
                                 max_connections=max_connections)
    if uri.startswith("mem://"):
        return RemoteObjectStore(ServerTransport(), uri=uri,
                                 part_size=part_size, retry=retry,
                                 timeout_s=timeout_s,
                                 max_connections=max_connections)
    if uri.startswith("file://"):
        return LocalFSStore(uri[len("file://"):], batch_fsync=batch_fsync)
    return LocalFSStore(uri, batch_fsync=batch_fsync)


def wrap_faulty(store: RemoteObjectStore, spec: FaultSpec) -> FaultyTransport:
    """Interpose a :class:`FaultyTransport` under an existing remote store
    (in place); returns the injector for observability."""
    faulty = FaultyTransport(store.transport, spec)
    store.transport = faulty
    return faulty
