"""The port's remote object store (``repro_torch.core.remote_store``,
``repro_torch.core.object_server``), on the CPU: every case of
``tests/test_remote_store.py`` (transport contract, retry taxonomy,
idempotent multipart, write-through visibility verify, HTTP front end),
then the wire protocol as a contract between the packages — a port client
issues the reference client's requests byte for byte, both servers answer
one request log alike, and a port client works against a reference
server (in process and over HTTP) and the reverse, through whole
checkpoint saves and restores."""

import os
import threading
import time

import pytest

from repro_torch.core.object_server import serve
from repro_torch.core.remote_store import (
    ChecksumMismatchError,
    FatalTransportError,
    FaultSpec,
    RemoteObjectStore,
    RemoteVerifyError,
    Response,
    RetriesExhaustedError,
    RetryPolicy,
    ServerTransport,
    ThrottledTransport,
    Transport,
    TransportConnectionReset,
    TransportTimeout,
    make_store,
    obj_path,
    wrap_faulty,
)
from repro_torch.core.storage import LocalFSStore

FAST = RetryPolicy(attempts=6, base_s=0.0005, cap_s=0.005)


def make_remote(part_size=1 << 20, retry=FAST, **kw):
    return RemoteObjectStore(ServerTransport(), part_size=part_size,
                             retry=retry, **kw)


# ------------------------------------------------------------ basic surface
def test_object_store_surface_roundtrip():
    st = make_remote()
    st.put("chunks/a", b"hello")
    assert st.get("chunks/a") == b"hello"
    assert st.exists("chunks/a")
    assert st.size("chunks/a") == 5
    assert st.list("chunks/") == ["chunks/a"]
    assert st.counters.bytes_written == 5
    st.delete("chunks/a")
    assert not st.exists("chunks/a")
    st.delete("chunks/a")  # delete of a missing key is a no-op
    with pytest.raises(KeyError):
        st.get("chunks/a")
    with pytest.raises(KeyError):
        st.size("chunks/a")


def test_put_many_get_many_roundtrip():
    st = make_remote()
    items = [(f"chunks/k{i:03d}", bytes([i]) * (i + 1)) for i in range(17)]
    st.put_many(items, max_workers=4)
    assert st.get_many([k for k, _ in items]) == [d for _, d in items]


# --------------------------------------------------------------- multipart
def test_multipart_roundtrip_and_threshold():
    st = make_remote(part_size=100)
    small = os.urandom(100)           # == part_size → single-shot
    big = os.urandom(1001)            # 11 parts
    st.put("chunks/small", small)
    st.put("chunks/big", big)
    assert st.get("chunks/small") == small
    assert st.get("chunks/big") == big
    assert st.size("chunks/big") == 1001


def test_multipart_duplicate_complete_is_idempotent():
    """A retried complete after the first applied (and upload state was
    reaped) must succeed against the existing object — the response-lost
    delivery path."""
    transport = ServerTransport()
    st = RemoteObjectStore(transport, part_size=64, retry=FAST)
    data = os.urandom(300)
    st.put("chunks/a", data)
    import json
    import zlib
    crc = f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    uid = f"{crc}-{len(data)}"
    parts = [[i // 64 + 1,
              f"{zlib.crc32(data[i:i + 64]) & 0xFFFFFFFF:08x}"]
             for i in range(0, len(data), 64)]
    body = json.dumps({"parts": parts}).encode()
    resp = transport.request(
        "POST", f"/mpu/chunks/a", body=body,
        params={"uploadId": uid, "action": "complete", "crc": crc})
    assert resp.status == 200
    assert st.get("chunks/a") == data
    # a duplicate complete with a DIFFERENT crc must refuse (409 → fatal)
    resp = transport.request(
        "POST", f"/mpu/chunks/a", body=body,
        params={"uploadId": uid, "action": "complete", "crc": "00000000"})
    assert resp.status == 409


def test_retried_identical_put_is_byte_safe():
    """Same key, same bytes, delivered twice (duplicate commit-time put):
    second delivery is absorbed, bytes unchanged."""
    st = make_remote(part_size=64)
    data = os.urandom(200)
    st.put("manifests/ckpt_000000000001.json", data)
    st.put("manifests/ckpt_000000000001.json", data)
    assert st.get("manifests/ckpt_000000000001.json") == data


def test_partial_upload_never_visible():
    """A body that arrives truncated fails the declared-checksum test and
    is discarded server-side — no torn object."""
    transport = ServerTransport()
    resp = transport.request("PUT", obj_path("chunks/a"),
                             body=b"torn-fragment",
                             params={"crc": "00000001"})  # wrong on purpose
    assert resp.status == 400
    assert not transport.backing.exists("chunks/a")


# ------------------------------------------------------------- retry logic
class _ScriptedTransport(Transport):
    """Yields scripted outcomes (exceptions or Responses) in order; then
    delegates to an inner ServerTransport."""

    def __init__(self, script):
        self.script = list(script)
        self.inner = ServerTransport()
        self.calls = 0

    def request(self, method, path, body=b"", params=None, timeout_s=None):
        self.calls += 1
        if self.script:
            item = self.script.pop(0)
            if isinstance(item, Exception):
                raise item
            return item
        return self.inner.request(method, path, body=body, params=params,
                                  timeout_s=timeout_s)


@pytest.mark.parametrize("fault", [
    TransportTimeout("t"), TransportConnectionReset("r"),
    Response(503, b"unavailable"), Response(429, b"slow down"),
])
def test_transient_faults_retry_and_succeed(fault):
    t = _ScriptedTransport([fault, fault])
    st = RemoteObjectStore(t, retry=FAST)
    st.put("chunks/a", b"data")
    assert st.get("chunks/a") == b"data"
    assert st.stats.retries >= 2


def test_fatal_4xx_does_not_retry():
    t = _ScriptedTransport([Response(403, b"denied")])
    st = RemoteObjectStore(t, retry=FAST)
    with pytest.raises(FatalTransportError, match="403"):
        st.put("chunks/a", b"data")
    assert t.calls == 1                  # exactly one attempt — no retry


def test_retries_exhausted_surfaces_with_cause():
    t = _ScriptedTransport([TransportConnectionReset(f"r{i}")
                            for i in range(100)])
    st = RemoteObjectStore(t, retry=RetryPolicy(attempts=3, base_s=0.0005))
    with pytest.raises(RetriesExhaustedError) as ei:
        st.put("chunks/a", b"data")
    assert isinstance(ei.value.__cause__, TransportConnectionReset)
    assert t.calls == 3


def test_get_checksum_mismatch_is_fatal():
    t = _ScriptedTransport([Response(200, b"corrupted",
                                     {"etag": "deadbeef"})])
    st = RemoteObjectStore(t, retry=FAST)
    with pytest.raises(ChecksumMismatchError):
        st.get("chunks/a")


def test_backoff_is_capped_exponential_with_jitter():
    p = RetryPolicy(attempts=8, base_s=0.01, cap_s=0.05, jitter=0.5)
    d1, d4 = p.backoff(1), p.backoff(4)
    assert 0.01 <= d1 <= 0.015
    assert 0.05 <= d4 <= 0.075           # capped at cap_s before jitter
    assert p.backoff(7) <= 0.075
    nojit = RetryPolicy(base_s=0.01, jitter=0.0)
    assert nojit.backoff(2) == 0.02      # deterministic without jitter


def test_connection_pool_bounds_concurrency():
    gate_max = []

    class Counting(Transport):
        def __init__(self):
            self.inner = ServerTransport()
            self.inflight = 0
            self.lock = threading.Lock()

        def request(self, method, path, body=b"", params=None,
                    timeout_s=None):
            with self.lock:
                self.inflight += 1
                gate_max.append(self.inflight)
            time.sleep(0.002)
            try:
                return self.inner.request(method, path, body=body,
                                          params=params)
            finally:
                with self.lock:
                    self.inflight -= 1

    st = RemoteObjectStore(Counting(), retry=FAST, max_connections=2)
    st.put_many([(f"chunks/k{i}", b"x") for i in range(12)], max_workers=8)
    assert max(gate_max) <= 2


# ------------------------------------------------- write-through visibility
def test_vote_and_manifest_puts_verify_readback():
    st = make_remote()
    st.put("parts/ckpt_000000000001/host_0000.json", b"vote")
    st.put("manifests/ckpt_000000000001.json", b"manifest")
    assert st.stats.verify_gets == 2
    st.put("chunks/bulk", b"payload")
    assert st.stats.verify_gets == 2     # bulk keys skip the verify


def test_verify_raises_on_divergent_readback():
    class Lying(ServerTransport):
        def request(self, method, path, body=b"", params=None,
                    timeout_s=None):
            resp = super().request(method, path, body=body, params=params)
            if method == "GET" and path.startswith("/o/parts/"):
                return Response(200, b"someone-else's bytes")
            return resp

    st = RemoteObjectStore(Lying(), retry=FAST)
    with pytest.raises(RemoteVerifyError, match="reads back"):
        st.put("parts/ckpt_000000000001/host_0000.json", b"vote")


def test_verify_waits_out_delayed_visibility():
    """A key that turns visible only after a few readbacks still verifies
    (bounded retries with backoff) instead of failing fast."""
    class Delayed(ServerTransport):
        def __init__(self):
            super().__init__()
            self.hidden = 2

        def request(self, method, path, body=b"", params=None,
                    timeout_s=None):
            if (method == "GET" and path.startswith("/o/parts/")
                    and self.hidden > 0):
                self.hidden -= 1
                return Response(404, b"not yet visible")
            return super().request(method, path, body=body, params=params)

    st = RemoteObjectStore(Delayed(), retry=FAST)
    st.put("parts/ckpt_000000000001/host_0000.json", b"vote")  # no raise


# --------------------------------------------------------- fault injection
def test_faultspec_parse_roundtrip():
    spec = FaultSpec(seed=7, error_rate=0.2, partial_put_rate=0.1,
                     slow_rate=0.05, slow_s=0.01, list_lag=3)
    again = FaultSpec.parse(spec.to_arg())
    for f in FaultSpec.FIELDS:
        assert getattr(again, f) == getattr(spec, f)
    with pytest.raises(ValueError):
        FaultSpec.parse("bogus_field=1")


def test_faulty_transport_is_deterministic():
    def run():
        st = make_remote()
        inj = wrap_faulty(st, FaultSpec(seed=11, error_rate=0.3,
                                        partial_put_rate=0.1))
        for i in range(20):
            st.put(f"chunks/k{i}", bytes([i]) * 50)
        return inj.injected, st.stats.retries

    assert run() == run()


def test_faulty_transport_survives_20pct_and_data_is_intact():
    st = make_remote()
    inj = wrap_faulty(st, FaultSpec(seed=3, error_rate=0.2,
                                    partial_put_rate=0.05))
    blobs = {f"chunks/k{i}": os.urandom(100 + i) for i in range(40)}
    for k, d in blobs.items():
        st.put(k, d)
    for k, d in blobs.items():
        assert st.get(k) == d
    assert inj.injected > 0              # faults actually fired
    assert st.stats.retries >= inj.injected - 1


def test_list_visibility_lag_resolves():
    st = make_remote()
    wrap_faulty(st, FaultSpec(seed=0, list_lag=2))
    st.put("chunks/a", b"x")
    first = st.list("chunks/")           # epochs 1,2 hide the fresh key
    assert "chunks/a" not in first
    st.list("chunks/")
    assert st.list("chunks/") == ["chunks/a"]


def test_slow_request_beyond_budget_times_out_and_retries():
    st = RemoteObjectStore(ServerTransport(), retry=FAST, timeout_s=0.01)
    inj = wrap_faulty(st, FaultSpec(seed=5, slow_rate=0.3, slow_s=10.0))
    for i in range(10):
        st.put(f"chunks/k{i}", b"y" * 20)
        assert st.get(f"chunks/k{i}") == b"y" * 20
    assert inj.injected > 0


# ------------------------------------------------------- throttled transport
def test_throttled_transport_paces_uploads():
    st = RemoteObjectStore(
        ThrottledTransport(ServerTransport(), write_bytes_per_sec=100_000),
        retry=FAST)
    t0 = time.monotonic()
    st.put("chunks/a", b"x" * 20_000)    # 0.2 s at 100 kB/s
    assert time.monotonic() - t0 >= 0.15


def test_throttled_transport_charges_retransmissions():
    """Retried bodies occupy the link again — amplification costs real
    wall-clock, matching what the benchmark measures."""
    flaky = _ScriptedTransport([TransportConnectionReset("r")] * 2)
    st = RemoteObjectStore(
        ThrottledTransport(flaky, write_bytes_per_sec=100_000),
        retry=RetryPolicy(attempts=5, base_s=0.0005))
    t0 = time.monotonic()
    st.put("chunks/a", b"x" * 10_000)    # 3 transmissions of 0.1 s
    assert time.monotonic() - t0 >= 0.25
    assert st.stats.bytes_sent == 30_000
    assert st.stats.write_amplification(st.counters.bytes_written) == 3.0


# ------------------------------------------------------------ HTTP + factory
def test_http_server_roundtrip_including_multipart():
    server, port = serve()
    try:
        st = make_store(f"http://127.0.0.1:{port}", part_size=256,
                        retry=FAST)
        big = os.urandom(2000)
        st.put("chunks/big", big)
        st.put("parts/ckpt_000000000001/host_0000.json", b"vote")
        assert st.get("chunks/big") == big
        assert st.size("chunks/big") == 2000
        assert st.list("") == ["chunks/big",
                               "parts/ckpt_000000000001/host_0000.json"]
        st.delete("chunks/big")
        assert not st.exists("chunks/big")
        with pytest.raises(KeyError):
            st.get("chunks/big")
    finally:
        server.shutdown()


def test_http_server_durable_backing(tmp_path):
    """--root mode: the server persists through a LocalFSStore, so pods get
    the same crash durability as the shared-FS path."""
    backing = LocalFSStore(str(tmp_path))
    server, port = serve(backing=backing)
    try:
        st = make_store(f"http://127.0.0.1:{port}", retry=FAST)
        st.put("manifests/ckpt_000000000001.json", b"{}")
        assert (tmp_path / "manifests" / "ckpt_000000000001.json").exists()
    finally:
        server.shutdown()


def test_make_store_dispatch(tmp_path):
    assert isinstance(make_store(str(tmp_path)), LocalFSStore)
    assert isinstance(make_store(f"file://{tmp_path}"), LocalFSStore)
    assert make_store(str(tmp_path), batch_fsync=True).batch_fsync
    mem = make_store("mem://")
    assert isinstance(mem, RemoteObjectStore)
    mem.put("k", b"v")
    assert mem.get("k") == b"v"
    with pytest.raises(ValueError, match="host:port"):
        make_store("http://nohost")


# ------------------------------------------- the wire protocol across packages
class _Recording(Transport):
    """Logs every request (method, path, body, params) on its way to an
    inner transport."""

    def __init__(self, inner):
        self.inner = inner
        self.log = []

    def request(self, method, path, body=b"", params=None, timeout_s=None):
        self.log.append((method, path, bytes(body), dict(params or {})))
        return self.inner.request(method, path, body=body, params=params,
                                  timeout_s=timeout_s)


def _drive(store):
    """One sequence of store calls touching every request kind."""
    big = bytes(range(256)) * 5
    store.put("chunks/ckpt_000000000001/emb/000000.bin", big)       # multipart
    store.put("parts/ckpt_000000000001/host_0000.json", b"vote")    # verified
    store.put("manifests/ckpt_000000000001.json", b"{}")
    store.put_many([(f"chunks/k{i}", bytes([i]) * 7) for i in range(3)],
                   max_workers=1)
    out = [store.get("chunks/ckpt_000000000001/emb/000000.bin"),
           store.list("chunks/"), store.exists("chunks/k1"),
           store.size("chunks/k2"), store.get_many(["chunks/k0", "chunks/k2"])]
    store.delete("chunks/k1")
    out.append(store.exists("chunks/k1"))
    with pytest.raises(KeyError):
        store.get("chunks/missing")
    return out


def test_port_client_sends_the_reference_clients_requests():
    from repro.core import remote_store as ref_rs

    logs, outs = [], []
    for rs, server in ((ref_rs, ref_rs.ServerTransport()),
                       (None, ServerTransport())):
        rec = _Recording(server)
        make = rs.RemoteObjectStore if rs else RemoteObjectStore
        policy = rs.RetryPolicy if rs else RetryPolicy
        outs.append(_drive(make(rec, part_size=300,
                                retry=policy(attempts=2, base_s=0.0005))))
        logs.append(rec.log)
    assert len(logs[0]) > 15
    assert logs[0] == logs[1]
    assert outs[0] == outs[1]


def test_both_servers_answer_one_request_log_alike():
    from repro.core import remote_store as ref_rs

    rec = _Recording(ServerTransport())
    _drive(RemoteObjectStore(rec, part_size=300, retry=FAST))
    # a torn body and a conflicting complete, which both must refuse
    log = rec.log + [("PUT", obj_path("chunks/torn"), b"x",
                      {"crc": "00000001"})]
    answers = []
    for server in (ref_rs.ServerTransport(), ServerTransport()):
        answers.append([(r.status, r.body, dict(r.headers))
                        for r in (server.request(m, p, body=b, params=q)
                                  for m, p, b, q in log)])
    assert answers[0] == answers[1]
    assert {a[0] for a in answers[0]} >= {200, 404, 400}


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("wire", ["in_process", "http"])
def test_checkpoints_cross_the_wire_between_packages(tmp_path, client, server,
                                                     wire):
    """A client of one package saves a 4-host checkpoint chain (8-bit
    uniform, full then incremental) into a server of the other; the chunk
    objects it lands are the in-process save's byte for byte, and both
    packages restore it to the same state through either client."""
    from repro.core import remote_store as ref_rs
    from repro.core.object_server import serve as ref_serve
    from repro.core.storage import LocalFSStore as RefLocalFSStore
    from tests.test_torch_shard_writer import (
        assert_same_state, manager, save_sharded, sharded_snapshots)

    backing = (LocalFSStore if server == "port" else RefLocalFSStore)(
        str(tmp_path / "backing"))
    if wire == "http":
        srv, port = (serve if server == "port" else ref_serve)(backing=backing)
        uri = f"http://127.0.0.1:{port}"
        clients = {"port": lambda: make_store(uri, retry=FAST),
                   "ref": lambda: ref_rs.make_store(uri, retry=ref_rs.RetryPolicy(
                       attempts=6, base_s=0.0005, cap_s=0.005))}
    else:
        srv = None
        transport = (ServerTransport(backing=backing) if server == "port"
                     else ref_rs.ServerTransport(backing=backing))
        clients = {"port": lambda: RemoteObjectStore(transport, retry=FAST),
                   "ref": lambda: ref_rs.RemoteObjectStore(transport)}
    try:
        snaps = sharded_snapshots(seed=4)
        save_sharded(client, "u8", snaps, store=clients[client]())
        local = save_sharded(client, "u8", snaps)
        keys = sorted(local.list("chunks/"))
        assert keys and sorted(backing.list("chunks/")) == keys
        for k in keys:
            assert backing.get(k) == local.get(k), k
        for step in (1, 2):
            a = manager("port", clients["port"]())
            b = manager("ref", clients["ref"]())
            assert_same_state(a.restore(step), b.restore(step))
            a.close()
            b.close()
    finally:
        if srv is not None:
            srv.shutdown()
