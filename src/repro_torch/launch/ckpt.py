"""Checkpoint inspection / verification CLI (operational tooling).

  PYTHONPATH=src python -m repro_torch.launch.ckpt list   --dir /ckpts/job-1
  PYTHONPATH=src python -m repro_torch.launch.ckpt show   --dir /ckpts/job-1 --step 12000
  PYTHONPATH=src python -m repro_torch.launch.ckpt verify --dir /ckpts/job-1   # fsck
  PYTHONPATH=src python -m repro_torch.launch.ckpt scan   --dir /ckpts/job-1 \
      --quarantine            # full integrity audit; park corrupt steps
  PYTHONPATH=src python -m repro_torch.launch.ckpt validate --dir /ckpts/job-1 \
      --step 12000            # deep-verify ONE step + its recovery chain
  PYTHONPATH=src python -m repro_torch.launch.ckpt quarantine --dir /ckpts/job-1 \
      --step 12000 --reason "bit flips on rack 7"
  PYTHONPATH=src python -m repro_torch.launch.ckpt resume --dir /ckpts/job-1 \
      --policy last-known-good   # where can training restart?
  PYTHONPATH=src python -m repro_torch.launch.ckpt emit-metrics --dir /ckpts/job-1 \
      --textfile /var/lib/node_exporter/cnr.prom
  PYTHONPATH=src python -m repro_torch.launch.ckpt gc     --dir /ckpts/job-1 --keep 2
  PYTHONPATH=src python -m repro_torch.launch.ckpt gc-aborted --dir /ckpts/job-1
  PYTHONPATH=src python -m repro_torch.launch.ckpt commit --dir /ckpts/job-1 \
      --step 12000 --num-hosts 4   # finish phase 2 from durable votes
  PYTHONPATH=src python -m repro_torch.launch.ckpt recover --dir /ckpts/job-1 \
      --host 2 --fence --device cuda
                         # replay ONE host's shard chain (O(shard) bytes);
                         # falls back to a full restore if unrecoverable
  PYTHONPATH=src python -m repro_torch.launch.ckpt subscribe --dir /ckpts/job-1 \
      --follow --poll-s 2   # serving replica: follow the chain, apply
                            # per-step deltas (O(touched rows)/refresh)

``recover`` and ``reshard`` build a ``CheckNRunManager``, whose config
places quantization on a device: ``--device`` (default ``cuda``, which
raises when there is no card; ``cpu`` runs on the CPU). Every other
command reads the store on the host and ignores it. For the same store
each command prints the reference CLI's text (``src/repro/launch/ckpt.py``).

``--dir`` accepts a LocalFSStore root path OR a remote store URI
(``http://host:port`` of a ``repro_torch.core.object_server``), so every
operator recovery flow — inspecting a torn save, auditing and
quarantining corruption, finishing phase 2 from durable votes, reclaiming
aborted debris — works without a shared filesystem:

  PYTHONPATH=src python -m repro_torch.launch.ckpt scan   --dir http://10.0.0.5:9000
  PYTHONPATH=src python -m repro_torch.launch.ckpt commit --dir http://10.0.0.5:9000 \
      --step 12000 --num-hosts 4

See docs/integrity.md for the scan → quarantine → resume → restore
operator flow and the corrupt-store triage cookbook.
"""

from __future__ import annotations

import argparse
import sys
import time


def _print_scan(store, report, do_quarantine: bool = False) -> int:
    """Render a ScanReport; optionally park corrupt steps under corrupt/.
    Exit 0 iff no fatal corruption (benign reclaimed-part notes don't
    fail the scan)."""
    from ..core import integrity

    if not report.steps:
        print("no valid checkpoints")
        return 0
    for s in sorted(report.steps):
        rep = report.steps[s]
        for p in rep.problems:
            tag = "note" if not p.fatal else "FAIL"
            print(f"  [{tag}] {p.kind} {p.key}"
                  + (f" ({p.detail})" if p.detail else ""))
        mode = "verified" if report.deep else "present"
        print(f"step {s}: {'OK' if rep.ok else 'CORRUPT'} "
              f"({rep.chunks_checked} blobs {mode}, "
              f"{rep.bytes_checked:,} bytes)")
    for s in sorted(report.chain_problems):
        p = report.chain_problems[s]
        print(f"step {s}: UNRESTORABLE — {p.kind}: {p.detail}")
    corrupt = report.corrupt_steps
    if do_quarantine and corrupt:
        for s in corrupt:
            rep = report.steps[s]
            reasons = ", ".join(sorted({p.kind for p in rep.fatal_problems}))
            moved = integrity.quarantine_step(
                store, s, f"ckpt scan --quarantine: {reasons}",
                problems=rep.problems)
            print(f"quarantined step {s}: {len(moved)} blobs moved under "
                  f"{integrity.CORRUPT_PREFIX}ckpt_{s:012d}/")
    if corrupt or report.chain_problems:
        print(f"scan: {len(corrupt)} corrupt step(s), "
              f"{len(report.chain_problems)} unrestorable chain(s)")
        return 1
    print(f"scan: all {len(report.steps)} step(s) clean")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["list", "show", "verify", "scan",
                                    "validate", "quarantine", "resume",
                                    "emit-metrics", "gc", "gc-aborted",
                                    "commit", "recover", "reshard",
                                    "subscribe", "serve"])
    ap.add_argument("--dir", required=True,
                    help="LocalFSStore root path or remote store URI "
                         "(http://host:port)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--keep", type=int, default=1)
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="commit: expected quorum size; recover/reshard: "
                         "TARGET layout host count — may differ from the "
                         "layout the chain was written under "
                         "(docs/resharding.md)")
    ap.add_argument("--host", type=int, default=None,
                    help="recover: host index whose shard to replay; "
                         "reshard: additionally drill this target host's "
                         "range read")
    ap.add_argument("--fence", action="store_true",
                    help="recover: bump the host's fence epoch first so a "
                         "zombie writer at the old epoch exits on its next "
                         "heartbeat (docs/partial_recovery.md)")
    ap.add_argument("--all", action="store_true",
                    help="gc-aborted: also reclaim steps newer than the "
                         "latest committed manifest (UNSAFE unless no "
                         "writer is active — they may be in-flight saves)")
    ap.add_argument("--quick", action="store_true",
                    help="scan: structural audit only (existence + size; "
                         "no payload downloads, no crc/hash checks)")
    ap.add_argument("--quarantine", action="store_true",
                    help="scan: move every corrupt step under corrupt/ "
                         "with a REASON.json")
    ap.add_argument("--reason", default=None,
                    help="quarantine: why the step is being parked")
    ap.add_argument("--policy", default="last-known-good",
                    choices=["latest-valid", "last-known-good"],
                    help="resume: structural completeness vs full content "
                         "verification of the whole recovery chain")
    ap.add_argument("--textfile", default=None,
                    help="emit-metrics / subscribe: write Prometheus "
                         "textfile here (atomic) instead of stdout")
    ap.add_argument("--follow", action="store_true",
                    help="subscribe: keep polling after catching up "
                         "(Ctrl-C to stop); default is one catch-up to "
                         "the head step, then exit")
    ap.add_argument("--poll-s", type=float, default=2.0,
                    help="subscribe --follow: poll cadence in seconds")
    ap.add_argument("--max-polls", type=int, default=None,
                    help="subscribe --follow: stop after N polls "
                         "(default: poll forever)")
    ap.add_argument("--device", default="cuda",
                    help="recover/reshard: where the manager they build "
                         "places quantization (cuda: the card, raises "
                         "without one; cpu)")
    args = ap.parse_args(argv)

    from ..core import integrity, make_store, metrics
    from ..core import manifest as mf

    store = make_store(args.dir)

    if args.cmd == "scan":
        report = integrity.scan_store(store, deep=not args.quick)
        return _print_scan(store, report, do_quarantine=args.quarantine)

    if args.cmd == "validate":
        steps = mf.list_steps(store)
        if not steps:
            print("no valid checkpoints")
            return 1
        s = args.step if args.step is not None else steps[-1]
        try:
            chain = integrity.checked_chain(store, s)
        except integrity.ChunkCorruptionError as e:
            print(f"step {s}: BROKEN CHAIN — {e}")
            return 1
        report = integrity.scan_store(store, steps=[m.step for m in chain],
                                      deep=True)
        ok = True
        for m in chain:
            rep = report.steps[m.step]
            for p in rep.problems:
                tag = "note" if not p.fatal else "FAIL"
                print(f"  [{tag}] step {p.step}: {p.kind} {p.key}"
                      + (f" ({p.detail})" if p.detail else ""))
            ok &= rep.ok
            print(f"step {m.step}: "
                  f"{'OK' if rep.ok else 'CORRUPT'} "
                  f"({rep.chunks_checked} blobs, "
                  f"{rep.bytes_checked:,} bytes verified)")
        print(f"step {s} chain {[m.step for m in chain]}: "
              f"{'VALID' if ok else 'CORRUPT'}")
        return 0 if ok else 1

    if args.cmd == "quarantine":
        if args.step is None:
            print("quarantine requires --step")
            return 2
        known = set(mf.list_steps(store)) | set(
            mf.aborted_steps(store))
        if args.step not in known:
            print(f"step {args.step} has no manifest or blobs to quarantine")
            return 1
        rep = integrity.scan_step(store, args.step, deep=True)
        moved = integrity.quarantine_step(
            store, args.step,
            args.reason or "operator quarantine via ckpt CLI",
            problems=rep.problems)
        print(f"quarantined step {args.step}: {len(moved)} blobs moved "
              f"under {integrity.CORRUPT_PREFIX}ckpt_{args.step:012d}/")
        return 0

    if args.cmd == "resume":
        plan = integrity.plan_resume(store, deep=True)
        if plan.latest_step is None:
            print("no valid checkpoints")
            return 1
        print(f"latest committed:  {plan.latest_step}")
        print(f"latest valid:      {plan.latest_valid}")
        print(f"last known good:   {plan.last_known_good}")
        for s in plan.corrupt_steps:
            print(f"  corrupt step {s}: {plan.reasons.get(s, '?')}")
        chosen = (plan.latest_valid if args.policy == "latest-valid"
                  else plan.last_known_good)
        if chosen is None:
            print(f"no {args.policy} step exists — restore from a replica "
                  f"or accept data loss")
            return 1
        chain = [m.step for m in mf.recovery_chain(store, chosen)]
        print(f"resume from step {chosen} (chain {chain})")
        return 0

    if args.cmd == "emit-metrics":
        vals = metrics.store_metrics(store)
        text = metrics.render_prometheus(vals)
        if args.textfile:
            metrics.write_textfile(text, args.textfile)
            print(f"wrote {len(text)} bytes to {args.textfile}")
        else:
            sys.stdout.write(text)
        return 0

    if args.cmd in ("subscribe", "serve"):
        # serving-replica drill (docs/serving.md): follow the manifest
        # chain and keep an in-memory EmbeddingServer fresh by applying
        # per-step deltas — bytes fetched scale with touched rows, not
        # model size. `serve` == `subscribe --follow`. One-shot mode
        # (no --follow) catches up to the head step and exits, printing
        # what a cold replica would have paid.
        from ..serve import CheckpointSubscriber

        follow = args.follow or args.cmd == "serve"
        sub = CheckpointSubscriber(store)
        before = store.counters.snapshot()["bytes_read"]
        t0 = time.monotonic()

        def on_apply(step):
            m = sub.metrics()
            print(f"step {step}: {sub.last_refresh_wall_s:.3f}s, "
                  f"{m['refresh_bytes_total'] :,} bytes total, "
                  f"lag {m['lag_steps']} step(s), state {m['state']}")

        try:
            if follow:
                sub.follow(poll_s=args.poll_s, max_polls=args.max_polls,
                           on_apply=on_apply)
            else:
                if sub.poll_once():
                    on_apply(sub.applied_step)
        except KeyboardInterrupt:
            pass
        m = sub.metrics()
        nbytes = store.counters.snapshot()["bytes_read"] - before
        if m["applied_step"] is None:
            print(f"no checkpoint applied (state {m['state']}"
                  + (f": {sub.health.reason}" if sub.health.reason else "")
                  + ")")
            return 1
        print(f"serving step {m['applied_step']} (head {m['head_step']}, "
              f"lag {m['lag_steps']}): {m['applied_steps_total']} "
              f"refresh(es) — {m['incremental_refreshes_total']} "
              f"incremental, {m['full_syncs_total']} full — "
              f"{nbytes:,} bytes fetched in {time.monotonic() - t0:.2f}s")
        if m["holds_total"]:
            print(f"holds on corruption: {m['holds_total']} "
                  f"(last reason: {sub.health.reason})")
        if args.textfile:
            text = metrics.render_prometheus({"serve": m})
            metrics.write_textfile(text, args.textfile)
            print(f"wrote {len(text)} bytes to {args.textfile}")
        return 0

    if args.cmd == "gc-aborted":
        # reclaim chunk/part debris of crashed or cancelled saves; steps
        # newer than the latest committed manifest are protected by default
        # (they may be an in-flight save — pass --all to override when no
        # writer is active; the manager sweeps automatically post-commit)
        reclaimed = mf.gc_aborted(store, fence=None if args.all else "latest")
        for s, n in reclaimed.items():
            print(f"step {s}: reclaimed {n} orphaned blobs")
        print("nothing to reclaim" if not reclaimed else
              f"reclaimed {len(reclaimed)} aborted saves")
        return 0

    if args.cmd == "commit":
        # coordinator-less operational recovery: if every host's phase-1
        # vote is durable but the last voter died before the manifest put,
        # ANY process can finish phase 2 idempotently. The commit context
        # is reconstructed from the previous committed manifest's chain
        # position (full checkpoints only — an incremental save's policy
        # state lives in the writer; rerun the save for those).
        if args.step is None or args.num_hosts is None:
            print("commit requires --step and --num-hosts")
            return 2
        from ..core import CommitContext, ShardCommitError, try_commit

        if store.exists(mf.manifest_key(args.step)):
            print(f"step {args.step} is already committed")
            return 0
        hosts = mf.list_part_hosts(store, args.step)
        if hosts != list(range(args.num_hosts)):
            print(f"cannot commit step {args.step}: votes present for hosts "
                  f"{hosts}, need all of 0..{args.num_hosts - 1}")
            return 1
        # refuse incremental votes: this tool stamps kind="full", and an
        # incremental save committed as "full" would silently zero every
        # untouched row on restore. Full-save chunks are range-encoded
        # (row_range set) and together cover every table row exactly.
        parts = [mf.load_part(store, args.step, h)
                 for h in range(args.num_hosts)]
        covered: dict = {}
        rows_of: dict = {}
        for part in parts:
            for name, rec in part.tables.items():
                rows_of[name] = rec.rows
                for ch in rec.chunks:
                    if ch.row_range is None:
                        print(f"commit refused: step {args.step} was an "
                              f"INCREMENTAL save (table {name!r} has "
                              f"index-encoded chunks); its policy state "
                              f"lives in the writer — rerun the save")
                        return 1
                covered[name] = covered.get(name, 0) + sum(
                    c.n_rows for c in rec.chunks)
        short = {n: (covered.get(n, 0), r) for n, r in rows_of.items()
                 if covered.get(n, 0) != r}
        if short:
            print(f"commit refused: step {args.step} does not cover every "
                  f"row (stored vs total: {short})")
            return 1
        prev = mf.latest_step(store)
        sample = next(iter(parts[0].tables.values()), None)
        quant = (dict(bits=sample.bits, method=sample.method,
                      num_bins=None, ratio=None)
                 if sample is not None and sample.bits is not None else None)
        ctx = CommitContext(kind="full", base_step=args.step, prev_step=prev,
                            quant=quant, policy={"name": "full_only"},
                            extra={"bitwidth": None,
                                   "recovered_by": "ckpt commit"})
        try:
            man = try_commit(store, args.step, args.num_hosts, ctx)
        except ShardCommitError as e:
            print(f"commit refused: {e}")
            return 1
        # a GC sweep racing this offline commit can have deleted chunk
        # blobs between our verification and the manifest put — re-verify
        # and roll the manifest back rather than leave a torn "valid"
        # checkpoint (see manifest._delete_step_batch)
        missing = [ch.key for rec in man.tables.values()
                   for ch in rec.chunks if not store.exists(ch.key)]
        missing += [d.key for d in man.dense.values()
                    if not store.exists(d.key)]
        if missing:
            store.delete(mf.manifest_key(man.step))
            print(f"commit rolled back: {len(missing)} chunk blob(s) were "
                  f"swept concurrently (first: {missing[0]}); re-run after "
                  f"stopping GC")
            return 1
        print(f"committed step {man.step}: {man.nbytes_total:,} bytes from "
              f"{args.num_hosts} durable parts")
        return 0

    if args.cmd == "recover":
        # operator drill / replacement-host warmup: replay ONE host's shard
        # chain and report what a partial recovery would splice — O(shard)
        # bytes fetched, not O(model). Degrades to a full restore when the
        # shard is unrecoverable (typed PartialRecoveryError), so the
        # command always ends with usable state or a hard failure.
        if args.host is None:
            print("recover requires --host")
            return 2
        from ..core import (CheckNRunManager, CheckpointConfig,
                            PartialRecoveryError)
        from ..dist import recovery as rcv

        s = args.step if args.step is not None else mf.latest_step(store)
        if s is None:
            print("no valid checkpoints")
            return 1
        if args.fence:
            epoch = rcv.fence_host(store, args.host)
            print(f"fenced host {args.host} at epoch {epoch}")
        mgr = CheckNRunManager(store, CheckpointConfig(async_write=False,
                                                       device=args.device))
        before = store.counters.snapshot()["bytes_read"]
        t0 = time.monotonic()
        try:
            try:
                rs = mgr.restore_part(args.host, s,
                                      num_hosts=args.num_hosts)
                kind = ("resharded"
                        if rs.extra["shard"].get("resharded") else "partial")
            except PartialRecoveryError as e:
                print(f"partial recovery unavailable ({e.kind}): {e.detail}")
                print("falling back to full restore")
                try:
                    rs = mgr.restore(s, on_corruption="fallback")
                except (KeyError, FileNotFoundError, ValueError) as e2:
                    print(f"full restore failed too: {e2}")
                    return 1
                kind = "full"
        finally:
            mgr.close()
        wall = time.monotonic() - t0
        nbytes = store.counters.snapshot()["bytes_read"] - before
        rows = sum(t.shape[0] for t in rs.tables.values())
        print(f"recovered host {args.host} ({kind}) at step {rs.step} "
              f"(chain of {rs.chain_len}): {rows:,} rows across "
              f"{len(rs.tables)} tables, {nbytes:,} bytes fetched "
              f"in {wall:.2f}s")
        if kind != "full":
            shard = rs.extra["shard"]
            if kind == "resharded":
                hist = ", ".join(str(n) for n in shard.get(
                    "source_layouts", [shard["source_num_hosts"]]))
                print(f"  resharded read: chain layout(s) [{hist}] -> "
                      f"target {shard['num_hosts']} host(s)")
            for name, rng in sorted(shard["row_range"].items()):
                print(f"  table {name}: rows [{rng[0]}, {rng[1]})")
        if rs.degraded_from is not None:
            print(f"DEGRADED: step {rs.degraded_from} was unrestorable; "
                  f"recovered from older step {rs.step} — the gap is lost "
                  f"training to redo")
        return 0

    if args.cmd == "reshard":
        # plan (and with --host, drill) a layout change: for each host of
        # the TARGET layout, the row ranges it would own and the bytes a
        # range-read restore fetches for them — O(target shard), however
        # the chain was written (docs/resharding.md)
        if args.num_hosts is None:
            print("reshard requires --num-hosts (the target layout)")
            return 2
        from ..core import CheckNRunManager, CheckpointConfig
        from ..core import range_reader as rr
        from ..dist import recovery as rcv

        s = args.step if args.step is not None else mf.latest_step(store)
        if s is None:
            print("no valid checkpoints")
            return 1
        chain = mf.recovery_chain(store, s)
        final = chain[-1]
        hist = " -> ".join(f"step {m.step}: {rr.layout_num_hosts(m)}h"
                           for m in chain)
        print(f"layout history: {hist}")
        print(f"reshard plan: {rr.layout_num_hosts(final)} -> "
              f"{args.num_hosts} host(s) at step {s}")
        total = 0
        for h in range(args.num_hosts):
            targets = rr.shard_targets(final.tables, h, args.num_hosts)
            rows = sum(hi - lo for lo, hi in targets.values())
            nb = rcv.shard_nbytes(store, h, s, num_hosts=args.num_hosts)
            total += nb
            print(f"  host {h:>3}: {rows:,} rows, {nb:,} planned bytes")
        full_bytes = sum(m.nbytes_total for m in chain)
        print(f"total planned: {total:,} bytes "
              f"(full chain: {full_bytes:,})")
        if args.host is None:
            return 0
        # drill: actually perform one target host's range read
        mgr = CheckNRunManager(store, CheckpointConfig(async_write=False,
                                                       device=args.device))
        before = store.counters.snapshot()["bytes_read"]
        t0 = time.monotonic()
        try:
            rs = mgr.restore_part(args.host, s, num_hosts=args.num_hosts)
        finally:
            mgr.close()
        nbytes = store.counters.snapshot()["bytes_read"] - before
        rows = sum(t.shape[0] for t in rs.tables.values())
        print(f"drilled host {args.host} of {args.num_hosts}: {rows:,} "
              f"rows, {nbytes:,} bytes fetched in "
              f"{time.monotonic() - t0:.2f}s")
        for name, rng in sorted(rs.extra["shard"]["row_range"].items()):
            print(f"  table {name}: rows [{rng[0]}, {rng[1]})")
        return 0

    steps = mf.list_steps(store)
    if not steps:
        print("no valid checkpoints")
        return 1

    if args.cmd == "list":
        print(f"{'step':>10} {'kind':<12} {'MB':>9} {'tables':>7} {'age':>10}")
        for s in steps:
            m = mf.load(store, s)
            age = time.time() - m.created_unix
            print(f"{s:>10} {m.kind:<12} {m.nbytes_total/1e6:9.2f} "
                  f"{len(m.tables):>7} {age/3600:9.1f}h")
        return 0

    if args.cmd == "show":
        s = args.step or steps[-1]
        m = mf.load(store, s)
        print(f"step {m.step} ({m.kind}); base={m.base_step} prev={m.prev_step}")
        print(f"policy: {m.policy.get('name')}  quant: {m.quant}")
        # sharded manifests are byte-deterministic: no per-committer wall
        # clock is recorded (timings live in SaveResult, not the store)
        wall = "n/a (sharded)" if m.shards else f"{m.wall_time_s:.2f}s"
        print(f"total bytes: {m.nbytes_total:,}  wall: {wall}")
        if m.extra.get("degraded_from"):
            d = m.extra["degraded_from"]
            print(f"DEGRADED LINEAGE: this chain was fallback-restored "
                  f"({d.get('reason', '?')}; resumed from step "
                  f"{d.get('restored_step', '?')})")
        if m.shards:
            hosts = mf.list_part_hosts(store, m.step)
            print(f"sharded: {m.shards['num_hosts']} hosts "
                  f"({len(hosts)} parts durable)")
            # per-host shard coverage; a retention/GC-reclaimed part
            # manifest (benign — payload intact) is reconstructed from the
            # global manifest's host-namespaced chunk keys, same as
            # restore_part does
            for p in m.shards["parts"]:
                h = p["host"]
                note = ""
                try:
                    part = mf.load_part(store, m.step, h)
                    chunks = [ch for rec in part.tables.values()
                              for ch in rec.chunks]
                    nbytes = part.nbytes_total
                except (KeyError, FileNotFoundError):
                    prefix = mf.chunk_host_prefix(m.step, h)
                    chunks = [ch for rec in m.tables.values()
                              for ch in rec.chunks
                              if ch.key.startswith(prefix)]
                    nbytes = sum(ch.nbytes for ch in chunks)
                    note = "  (part manifest reclaimed; payload intact)"
                rows = sum(ch.n_rows for ch in chunks)
                print(f"  host {h:>3}: {rows:,} rows, {nbytes:,} bytes "
                      f"in {len(chunks)} chunks{note}")
        chain = mf.recovery_chain(store, s)
        print(f"recovery chain: {[c.step for c in chain]}")
        from ..core import range_reader as rr
        layouts = [rr.layout_num_hosts(c) for c in chain]
        if len(set(layouts)) > 1:
            hist = " -> ".join(f"step {c.step}: {n}h"
                               for c, n in zip(chain, layouts))
            print(f"layout history: {hist}  (RESHARDED chain — "
                  f"restore_part range-reads across the change)")
        else:
            print(f"layout: {layouts[-1]} host(s) across the chain")
        for name, rec in m.tables.items():
            rows_stored = sum(c.n_rows for c in rec.chunks)
            print(f"  table {name}: {rec.rows}×{rec.dim} "
                  f"({rows_stored} rows stored in {len(rec.chunks)} chunks, "
                  f"{100*rows_stored/max(rec.rows,1):.1f}%)")
        return 0

    if args.cmd == "verify":
        # the original fsck, now over the shared integrity scanner: every
        # blob downloaded once, crc32 + hash32 checked from the same bytes.
        # A part manifest reclaimed by GC/retention under an intact payload
        # prints as a labelled NOTE and does NOT fail the fsck — only
        # genuinely missing data exits non-zero (manifest.py's
        # _delete_step_batch commit-race leaves exactly this debris).
        report = integrity.scan_store(store, deep=True)
        total_bad = 0
        for s in steps:
            rep = report.steps[s]
            for p in rep.problems:
                if p.kind == "reclaimed-part":
                    print(f"NOTE retention-reclaimed part {p.key} "
                          f"(payload intact)")
                elif p.kind.startswith("missing"):
                    print(f"MISSING {p.key}" if p.kind != "missing-part"
                          else f"MISSING PART {p.key}")
                elif p.kind == "part-crc-mismatch":
                    print(f"CORRUPT PART {p.key}")
                else:
                    print(f"CORRUPT {p.key} ({p.kind})")
            bad = len(rep.fatal_problems)
            print(f"step {s}: {'OK' if bad == 0 else f'{bad} problems'}")
            total_bad += bad
        return 1 if total_bad else 0

    if args.cmd == "gc":
        deleted = mf.apply_retention(store, keep_latest=args.keep)
        print(f"deleted checkpoints: {deleted or 'none'}")
        return 0


if __name__ == "__main__":
    sys.exit(main())
