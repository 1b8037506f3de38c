"""The port's checkpoint CLI (``repro_torch.launch.ckpt``) against the
reference's (``repro.launch.ckpt``), on the CPU.

Each case builds a small store with one package's manager (either writer),
copies it twice, runs one subcommand with the reference CLI on one copy and
the port CLI on the other, and holds the two to the same exit code, the
same printed text (wall times and ages aside) and, for the subcommands
that change the store, the same keys afterwards. The cases cover the CLI
cases of ``tests/test_integrity.py`` (scan, quick scan, resume, validate,
quarantine, verify, emit-metrics, an empty store), ``show`` with per-host
coverage, a reclaimed part and degraded lineage, ``gc``, ``gc-aborted``,
``commit`` from durable votes, ``recover`` (partial, fenced, resharded,
and the fallback to a full restore on a corrupt shard), ``reshard`` (plan
and drill) and a one-shot ``subscribe``; ``recover`` and ``reshard`` take
``--device cpu`` in the port. Over HTTP: the port CLI with ``--dir
http://…`` on an object server prints what it prints on the directory.
A subscriber process SIGKILLed mid-follow leaves the store whole.
"""

import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.launch.ckpt import main as ref_main
from repro_torch.core import LocalFSStore, make_store
from repro_torch.core import manifest as mf
from repro_torch.core.object_server import serve
from repro_torch.launch.ckpt import main as port_main
from tests.test_torch_shard_writer import snapshot_arrays

WRITERS = ["ref", "port"]
# commands that build a manager take the device in the port
DEVICE_CMDS = ("recover", "reshard")


def _packages(writer):
    if writer == "ref":
        from repro.core import CheckNRunManager, CheckpointConfig, LocalFSStore as S
        from repro.core import Snapshot
        return CheckNRunManager, lambda **kw: CheckpointConfig(**kw), S, Snapshot
    from repro_torch.core import CheckNRunManager, CheckpointConfig, Snapshot
    return (CheckNRunManager, lambda **kw: CheckpointConfig(device="cpu", **kw),
            LocalFSStore, Snapshot)


def _touch(arrays, step, seed):
    rng = np.random.default_rng(seed)
    out = dict(arrays, step=step, touched={}, tables={})
    for name, tab in arrays["tables"].items():
        tab = tab.copy()
        idx = rng.choice(tab.shape[0], size=40, replace=False)
        tab[idx] += rng.normal(size=(40, tab.shape[1])).astype(np.float32)
        mask = np.zeros(tab.shape[0], bool)
        mask[idx] = True
        out["tables"][name] = tab
        out["touched"][name] = mask
    return out


def _flip(root, key):
    with open(os.path.join(root, key), "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0x40
    with open(os.path.join(root, key), "wb") as f:  # rot in place
        f.write(bytes(blob))


def build(kind, writer, root):
    """One store of ``kind``, written by ``writer``'s manager."""
    Manager, Config, Store, Snapshot = _packages(writer)
    store = Store(root)
    base = dict(async_write=False, chunk_rows=64, keep_latest=10)
    if kind == "empty":
        return
    if kind in ("chain", "corrupt"):
        mgr = Manager(store, Config(policy="consecutive", **base))
        arrays = snapshot_arrays(step=1, seed=1)
        for s in range(1, 5):
            arrays = arrays if s == 1 else _touch(arrays, s, 99 + s)
            mgr.save(Snapshot(**arrays), block=True).result()
        mgr.close()
        if kind == "corrupt":
            _flip(root, next(k for k in sorted(store.list(mf.chunk_prefix(3)))
                             if k.endswith(".bin") and "/dense/" not in k))
        return
    if kind in ("sharded", "sharded_corrupt", "torn"):
        mgr = Manager(store, Config(policy="one_shot", quant=None, num_hosts=4,
                                    **base))
        a1 = snapshot_arrays(step=1)
        mgr.save(Snapshot(**a1)).result()
        a2 = _touch(a1, 2, 5)
        a2["extra"] = {"degraded_from": {"reason": "corrupt-chain fallback",
                                         "restored_step": 0}}
        mgr.save(Snapshot(**a2)).result()
        mgr.close()
        if kind == "sharded":   # a retention-reclaimed part
            store.delete(mf.part_key(1, 0))
        if kind == "sharded_corrupt":
            _flip(root, next(k for k in sorted(store.list(mf.chunk_host_prefix(2, 3)))
                             if k.endswith(".bin")))
        if kind == "torn":      # every committer died at the manifest put
            mgr = Manager(store, Config(policy="full_only", quant=None,
                                        num_hosts=4, **base))
            mgr.save(Snapshot(**dict(a2, step=3, extra={}))).result()
            mgr.close()
            store.delete(mf.manifest_key(3))
        return
    if kind == "resharded":     # step 1 at 4 hosts, step 2 at 2
        m4 = Manager(store, Config(policy="one_shot", quant=None, num_hosts=4,
                                   **base))
        a1 = snapshot_arrays(step=1)
        m4.save(Snapshot(**a1)).result()
        m4.close()
        m2 = Manager(store, Config(policy="one_shot", quant=None, num_hosts=2,
                                   **base))
        m2.restore()
        m2.policy.state.baseline_step = 1
        m2.save(Snapshot(**_touch(a1, 2, 3))).result()
        m2.close()
        return
    raise ValueError(kind)


# (store kind, argv after the subcommand's --dir, exit code, text it prints)
CASES = [
    ("chain", ["list"], 0, "incremental"),
    ("chain", ["show"], 0, "recovery chain: [1, 2, 3, 4]"),
    ("chain", ["show", "--step", "2"], 0, "step 2 (incremental)"),
    ("chain", ["verify"], 0, "step 4: OK"),
    ("chain", ["scan"], 0, "all 4 step(s) clean"),
    ("chain", ["scan", "--quick"], 0, "blobs present"),
    ("chain", ["validate", "--step", "3"], 0, "VALID"),
    ("chain", ["resume"], 0, "resume from step 4"),
    ("chain", ["emit-metrics"], 0, "cnr_steps_committed 4"),
    ("chain", ["gc", "--keep", "2"], 0, "deleted checkpoints"),
    ("chain", ["gc-aborted"], 0, "nothing to reclaim"),
    ("chain", ["quarantine", "--step", "4", "--reason", "operator drill"], 0,
     "quarantined step 4"),
    ("chain", ["quarantine", "--step", "9"], 1, "no manifest or blobs"),
    ("chain", ["quarantine"], 2, "requires --step"),
    ("chain", ["subscribe"], 0, "serving step 4"),
    ("corrupt", ["scan"], 1, "step 3: CORRUPT"),
    ("corrupt", ["scan", "--quick"], 0, "all 4 step(s) clean"),
    ("corrupt", ["resume"], 0, "resume from step 2"),
    ("corrupt", ["resume", "--policy", "latest-valid"], 0, "latest valid"),
    ("corrupt", ["validate", "--step", "3"], 1, "CORRUPT"),
    ("corrupt", ["validate", "--step", "1"], 0, "VALID"),
    ("corrupt", ["scan", "--quarantine"], 1, "quarantined step 3"),
    ("corrupt", ["verify"], 1, "step 3: 1 problems"),
    ("sharded", ["show", "--step", "1"], 0, "part manifest reclaimed; payload intact"),
    ("sharded", ["show"], 0, "DEGRADED LINEAGE"),
    ("sharded", ["verify"], 0, "retention-reclaimed"),
    ("sharded", ["recover", "--host", "2", "--fence"], 0,
     "fenced host 2 at epoch 1"),
    ("sharded", ["recover", "--host", "1"], 0, "recovered host 1 (partial) at step 2"),
    ("sharded", ["recover"], 2, "recover requires --host"),
    ("sharded", ["reshard", "--num-hosts", "2", "--host", "0"], 0,
     "drilled host 0 of 2:"),
    ("sharded", ["reshard"], 2, "reshard requires --num-hosts"),
    ("sharded_corrupt", ["recover", "--host", "3"], 0,
     "partial recovery unavailable (corrupt-chunk)"),
    ("torn", ["commit", "--step", "3", "--num-hosts", "4"], 0, "committed step 3"),
    ("torn", ["commit", "--step", "3", "--num-hosts", "2"], 1, "cannot commit"),
    ("torn", ["commit", "--step", "3"], 2, "requires --step and --num-hosts"),
    ("resharded", ["recover", "--host", "1", "--num-hosts", "2"], 0,
     "resharded read: chain layout(s) [4, 2] -> target 2 host(s)"),
    ("resharded", ["show"], 0, "RESHARDED chain"),
    ("resharded", ["reshard", "--num-hosts", "3"], 0,
     "reshard plan: 2 -> 3 host(s) at step 2"),
    ("empty", ["scan"], 0, "no valid checkpoints"),
    ("empty", ["resume"], 1, "no valid checkpoints"),
    ("empty", ["validate"], 1, "no valid checkpoints"),
    ("empty", ["emit-metrics"], 0, "cnr_steps_committed 0"),
    ("empty", ["list"], 1, "no valid checkpoints"),
]


def normalize(text: str) -> str:
    """Wall times and ages vary between two runs; nothing else may."""
    text = re.sub(r"\d+\.\d+s\b", "<s>", text)
    text = re.sub(r"(_age_s) [\d.e+-]+$", r"\1 <age>", text, flags=re.M)
    return re.sub(r"-?\d+\.\dh$", "<age>h", text, flags=re.M)


# A partial recovery that meets a corrupt chunk stops its restore pipeline
# with other fetches in flight, so the bytes it read before falling back
# vary from run to run, in either package (the same CLI twice on one store
# has printed both 110,418 and 111,442): that one number is not compared.
RACY_BYTES = {("sharded_corrupt", "recover")}


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, normalize(capsys.readouterr().out)


def port_argv(argv):
    return argv + (["--device", "cpu"] if argv[0] in DEVICE_CMDS else [])


def _keys(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    """Every store kind built once by each writer; cases copy them."""
    base = tmp_path_factory.mktemp("stores")
    out = {}
    for writer in WRITERS:
        for kind in sorted({c[0] for c in CASES}):
            root = str(base / f"{writer}_{kind}")
            build(kind, writer, root)
            out[writer, kind] = root
    return out


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("kind,argv,rc,expect", CASES,
                         ids=[f"{c[0]}-{'_'.join(c[1])}" for c in CASES])
def test_port_cli_prints_the_references(templates, tmp_path, capsys, writer,
                                        kind, argv, rc, expect):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(templates[writer, kind], ref_root)
    shutil.copytree(templates[writer, kind], port_root)
    ref = run(ref_main, [argv[0], "--dir", ref_root] + argv[1:], capsys)
    port = run(port_main, port_argv([argv[0], "--dir", port_root] + argv[1:]),
               capsys)
    assert port[0] == ref[0] == rc, (port, ref)
    assert expect in port[1]
    if (kind, argv[0]) in RACY_BYTES:
        ref, port = [(c, re.sub(r"[\d,]+ bytes fetched", "<n> bytes fetched", t))
                     for c, t in (ref, port)]
    assert port[1] == ref[1].replace(ref_root, port_root)
    # the subcommands that change the store change it the same way
    assert _keys(port_root) == _keys(ref_root)


def test_recover_and_reshard_default_to_the_card(templates, tmp_path, capsys):
    """Without ``--device`` the port's manager-building commands ask for
    the card, which this machine lacks: they raise, never run on the CPU
    in its place."""
    root = str(tmp_path / "s")
    shutil.copytree(templates["port", "sharded"], root)
    for argv in (["recover", "--dir", root, "--host", "1"],
                 ["reshard", "--dir", root, "--num-hosts", "2", "--host", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(argv)


@pytest.mark.parametrize("argv", [["scan"], ["show"], ["verify"], ["subscribe"],
                                  ["recover", "--host", "1", "--device", "cpu"]],
                         ids=lambda a: a[0])
def test_cli_over_http_prints_what_it_prints_on_the_directory(
        templates, tmp_path, capsys, argv):
    root = str(tmp_path / "s")
    shutil.copytree(templates["port", "sharded"], root)
    local = run(port_main, [argv[0], "--dir", root] + argv[1:], capsys)
    server, port = serve(backing=LocalFSStore(root))
    try:
        remote = run(port_main, [argv[0], "--dir", f"http://127.0.0.1:{port}"]
                     + argv[1:], capsys)
    finally:
        server.shutdown()
    assert remote == local


@pytest.mark.slow
def test_subscribe_process_sigkill_mid_apply_store_unharmed(templates,
                                                            tmp_path):
    """SIGKILL a follower process (``python -m repro_torch.launch.ckpt
    subscribe --follow``) mid-run: the store, which it only reads, stays
    restorable and a fresh subscriber converges to ``restore()``."""
    from repro_torch.core import CheckNRunManager, CheckpointConfig
    from repro_torch.serve import CheckpointSubscriber

    root = str(tmp_path / "s")
    shutil.copytree(templates["port", "chain"], root)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.ckpt", "subscribe",
         "--dir", root, "--follow", "--poll-s", "0.05", "--max-polls", "1000"],
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")), cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        # mid-follow: after its first apply, or before it
        deadline = time.monotonic() + 30
        line = b""
        while time.monotonic() < deadline and b"step " not in line:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert proc.returncode == -9
    store = LocalFSStore(root)
    assert mf.list_steps(store) == [1, 2, 3, 4]
    mgr = CheckNRunManager(store, CheckpointConfig(device="cpu"))
    want = mgr.restore(4)
    mgr.close()
    sub = CheckpointSubscriber(store)
    assert sub.poll_once() is True and sub.applied_step == 4
    with sub.server.pinned() as v:
        for name, tab in want.tables.items():
            np.testing.assert_array_equal(
                v.lookup(name, np.arange(tab.shape[0])), tab)


def test_remote_subscriber_catches_up_to_restore_bitwise(templates, tmp_path):
    """A ``CheckpointSubscriber`` over ``make_store("http://…")`` follows a
    chain (a full sync, then incremental refreshes as steps land) and
    serves exactly what a cold ``restore()`` gives at each step."""
    from repro_torch.core import CheckNRunManager, CheckpointConfig
    from repro_torch.serve import CheckpointSubscriber

    root = str(tmp_path / "s")
    shutil.copytree(templates["port", "chain"], root)
    backing = LocalFSStore(root)
    # hide steps 3 and 4, to land them one at a time
    later = {k: backing.get(k) for k in (mf.manifest_key(3), mf.manifest_key(4))}
    for k in later:
        backing.delete(k)
    server, port = serve(backing=backing)
    try:
        remote = make_store(f"http://127.0.0.1:{port}")
        sub = CheckpointSubscriber(remote)
        mgr = CheckNRunManager(LocalFSStore(root), CheckpointConfig(device="cpu"))
        for step in (2, 3, 4):
            if step > 2:
                backing.put(mf.manifest_key(step), later[mf.manifest_key(step)])
            assert sub.poll_once() is True and sub.applied_step == step
            want = mgr.restore(step)
            with sub.server.pinned() as v:
                for name, tab in want.tables.items():
                    got = v.lookup(name, np.arange(tab.shape[0]))
                    assert got.tobytes() == tab.tobytes(), (step, name)
        m = sub.metrics()
        assert m["full_syncs_total"] == 1 and m["incremental_refreshes_total"] == 2
        assert remote.stats.snapshot()["bytes_received"] > 0
        mgr.close()
    finally:
        server.shutdown()
