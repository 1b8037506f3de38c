"""Checkpoint integrity: scan, classify, quarantine, and resume planning.

The write path records two witnesses per chunk — a host-side crc32 of the
serialized payload and (when enabled) a device-side content hash of the
packed code words (``kernels.chunk_hash``). This module is the read-side
counterpart: walk a store's committed steps, re-derive both witnesses from
the stored bytes (ONE download per blob — crc and hash come from the same
``get``), classify every deviation, and plan where training can safely
resume. ``launch.ckpt`` exposes it as ``ckpt scan / validate / quarantine
/ resume``; ``CheckNRunManager.restore(on_corruption="fallback")`` uses
the same classification to replan onto the newest uncorrupted chain.

Problem kinds:

==================  =====  ==============================================
kind                fatal  meaning
==================  =====  ==============================================
manifest-unreadable  yes   committed manifest JSON fails to parse
missing-chunk        yes   chunk blob referenced by the manifest is gone
size-mismatch        yes   blob length != recorded nbytes
crc32-mismatch       yes   payload bytes fail the recorded crc32
hash32-mismatch      yes   primary section fails the device content hash
missing-dense        yes   dense blob gone / wrong size
broken-chain         yes   recovery chain is cyclic, forward-pointing,
                           or references a missing predecessor
missing-part         yes   part manifest gone AND the step's payload is
                           damaged (real loss, not housekeeping)
part-crc-mismatch    yes   part manifest bytes fail the recorded crc32
reclaimed-part       no    part manifest gone but every chunk and dense
                           blob is intact — the expected debris of a
                           commit that raced a GC sweep (see
                           ``manifest._delete_step_batch``); restore
                           never reads parts, so this is benign
==================  =====  ==============================================
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional

from . import manifest as mf
from .storage import ObjectStore

CORRUPT_PREFIX = "corrupt/"

#: problem kinds that do NOT make a step unrestorable
BENIGN_KINDS = frozenset({"reclaimed-part"})


class ChunkCorruptionError(IOError):
    """A stored blob failed integrity verification during decode.

    Subclasses :class:`IOError` so existing ``except IOError`` handlers
    (and tests pinning the old bare-IOError behaviour) keep working, but
    carries enough context — which step, table, key, and which witness
    failed — for the restore path to replan instead of dying blind.
    """

    def __init__(self, step: Optional[int], table: Optional[str], key: str,
                 kind: str, detail: str = ""):
        self.step = step
        self.table = table
        self.key = key
        self.kind = kind
        self.detail = detail
        where = f"step {step}" if step is not None else "unknown step"
        if table:
            where += f", table {table!r}"
        msg = f"{kind} for {key} ({where})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclasses.dataclass
class Problem:
    step: int
    key: str
    kind: str
    detail: str = ""

    @property
    def fatal(self) -> bool:
        return self.kind not in BENIGN_KINDS

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepReport:
    """Integrity verdict for one committed step (its own blobs only — chain
    health is a property of the *path* to a step, see :class:`ScanReport`)."""

    step: int
    problems: List[Problem] = dataclasses.field(default_factory=list)
    chunks_checked: int = 0
    bytes_checked: int = 0
    deep: bool = True

    @property
    def ok(self) -> bool:
        return not any(p.fatal for p in self.problems)

    @property
    def fatal_problems(self) -> List[Problem]:
        return [p for p in self.problems if p.fatal]

    @property
    def benign_problems(self) -> List[Problem]:
        return [p for p in self.problems if not p.fatal]


@dataclasses.dataclass
class ScanReport:
    steps: Dict[int, StepReport]
    chain_problems: Dict[int, Problem]  # step -> why its chain is unusable
    deep: bool

    @property
    def ok(self) -> bool:
        return not self.corrupt_steps and not self.chain_problems

    @property
    def corrupt_steps(self) -> List[int]:
        return sorted(s for s, r in self.steps.items() if not r.ok)

    @property
    def problems(self) -> List[Problem]:
        out = []
        for s in sorted(self.steps):
            out.extend(self.steps[s].problems)
        return out


def _hash32(payload: bytes) -> int:
    # lazy: pulls in the kernels package only when a hash is actually
    # recorded (mirrors checkpoint._kernel_quant_ops)
    from ..kernels.chunk_hash.ref import chunk_hash32
    return chunk_hash32(payload)


def primary_section(ch: mf.ChunkRecord) -> Optional[str]:
    """The section a chunk's ``hash32`` covers: the packed code stream for
    quantized chunks, the raw fp32 rows otherwise. Must match what the
    write path hashed (``checkpoint._encode_chunk``)."""
    if "codes" in ch.sections:
        return "codes"
    if "values" in ch.sections:
        return "values"
    return None


def verify_chunk_bytes(ch: mf.ChunkRecord, data: bytes,
                       step: Optional[int] = None,
                       table: Optional[str] = None) -> None:
    """Check one downloaded chunk payload against its manifest record;
    raises :class:`ChunkCorruptionError` naming the failed witness. The
    ONE verification the decode path, ``ckpt scan``, and the corruption
    drill all share."""
    if len(data) != ch.nbytes:
        raise ChunkCorruptionError(
            step, table, ch.key, "size-mismatch",
            f"got {len(data)} bytes, manifest records {ch.nbytes}")
    got_crc = ObjectStore.checksum(data)
    if got_crc != ch.crc32:
        raise ChunkCorruptionError(
            step, table, ch.key, "crc32-mismatch",
            f"got {got_crc:#010x}, manifest records {ch.crc32:#010x}")
    rec_hash = getattr(ch, "hash32", None)
    if rec_hash is not None:
        sec = primary_section(ch)
        if sec is not None:
            o, n = ch.sections[sec]
            got = _hash32(data[o:o + n])
            if got != rec_hash:
                raise ChunkCorruptionError(
                    step, table, ch.key, "hash32-mismatch",
                    f"section {sec!r}: got {got:#010x}, manifest records "
                    f"{rec_hash:#010x}")


def _check_blob(store: ObjectStore, step: int, key: str, nbytes: int,
                crc32: int, deep: bool, rep: StepReport,
                missing_kind: str = "missing-chunk",
                verify=None) -> None:
    """Shared blob check: quick = exists+size (no download); deep = one
    download feeding every recorded witness via ``verify(data)``."""
    if not deep:
        if not store.exists(key):
            rep.problems.append(Problem(step, key, missing_kind))
            return
        got = store.size(key)
        if got != nbytes:
            rep.problems.append(Problem(
                step, key, "size-mismatch",
                f"got {got} bytes, manifest records {nbytes}"))
        rep.chunks_checked += 1
        return
    try:
        data = store.get(key)
    except (KeyError, FileNotFoundError):
        # InMemoryStore raises KeyError, LocalFSStore FileNotFoundError
        rep.problems.append(Problem(step, key, missing_kind))
        return
    rep.chunks_checked += 1
    rep.bytes_checked += len(data)
    try:
        if verify is not None:
            verify(data)
        else:
            if len(data) != nbytes:
                raise ChunkCorruptionError(
                    step, None, key, "size-mismatch",
                    f"got {len(data)} bytes, manifest records {nbytes}")
            got = ObjectStore.checksum(data)
            if got != crc32:
                raise ChunkCorruptionError(
                    step, None, key, "crc32-mismatch",
                    f"got {got:#010x}, manifest records {crc32:#010x}")
    except ChunkCorruptionError as e:
        rep.problems.append(Problem(step, key, e.kind, e.detail))


def scan_step(store: ObjectStore, step: int, deep: bool = True) -> StepReport:
    """Verify one committed step's blobs. ``deep`` downloads each blob once
    and checks crc32 + hash32 from the same bytes; quick mode only checks
    existence and recorded size (no payload downloads at all)."""
    rep = StepReport(step=step, deep=deep)
    try:
        man = mf.load(store, step)
    except (KeyError, FileNotFoundError):
        rep.problems.append(Problem(step, mf.manifest_key(step),
                                    "missing-chunk", "manifest gone"))
        return rep
    except (ValueError, TypeError) as e:
        rep.problems.append(Problem(step, mf.manifest_key(step),
                                    "manifest-unreadable", str(e)))
        return rep

    for name, trec in man.tables.items():
        for ch in trec.chunks:
            if ch.n_rows == 0 and ch.nbytes == 0:
                continue
            _check_blob(
                store, step, ch.key, ch.nbytes, ch.crc32, deep, rep,
                verify=(lambda data, _ch=ch, _nm=name:
                        verify_chunk_bytes(_ch, data, step, _nm)))
    for drec in man.dense.values():
        _check_blob(store, step, drec.key, drec.nbytes, drec.crc32, deep,
                    rep, missing_kind="missing-dense")

    # Part manifests (sharded steps): restore never reads them, so a
    # missing part with a fully intact payload is GC housekeeping
    # (retention-reclaimed), not data loss. Only a missing/corrupt part
    # alongside payload damage is fatal — the vote record is then the
    # last breadcrumb of what was lost.
    payload_damaged = not rep.ok
    for p in (man.shards or {}).get("parts", []):
        pkey = p["key"]
        if not store.exists(pkey):
            kind = "missing-part" if payload_damaged else "reclaimed-part"
            rep.problems.append(Problem(
                step, pkey, kind,
                "payload damaged" if payload_damaged
                else "payload intact; vote reclaimed by GC/retention"))
            continue
        if deep and p.get("crc32") is not None:
            pdata = store.get(pkey)
            rep.bytes_checked += len(pdata)
            got = ObjectStore.checksum(pdata)
            if got != p["crc32"]:
                rep.problems.append(Problem(
                    step, pkey, "part-crc-mismatch",
                    f"got {got:#010x}, manifest records {p['crc32']:#010x}"))
    return rep


def checked_chain(store: ObjectStore, step: int) -> List[mf.Manifest]:
    """:func:`manifest.recovery_chain` with errors normalized: raises
    :class:`ChunkCorruptionError` (kind ``broken-chain``) for cyclic,
    forward-pointing, or missing-predecessor chains."""
    try:
        return mf.recovery_chain(store, step)
    except (ValueError, KeyError) as e:
        raise ChunkCorruptionError(step, None, mf.manifest_key(step),
                                   "broken-chain", str(e))
    except FileNotFoundError as e:
        raise ChunkCorruptionError(step, None, mf.manifest_key(step),
                                   "broken-chain",
                                   f"missing predecessor: {e}")


def scan_store(store: ObjectStore, steps: Optional[Iterable[int]] = None,
               deep: bool = True) -> ScanReport:
    """Walk committed steps (all, or the given subset) and verify each,
    plus each step's recovery-chain structure. Every blob is downloaded at
    most once across the whole scan (deep mode) — crc32 and hash32 are
    both derived from that single read."""
    all_steps = mf.list_steps(store)
    targets = sorted(set(steps)) if steps is not None else all_steps
    reports = {s: scan_step(store, s, deep=deep) for s in targets}
    chain_problems: Dict[int, Problem] = {}
    for s in targets:
        try:
            chain = checked_chain(store, s)
        except ChunkCorruptionError as e:
            chain_problems[s] = Problem(s, e.key, e.kind, e.detail)
            continue
        bad = [m.step for m in chain
               if m.step in reports and not reports[m.step].ok]
        # a structurally sound chain through a corrupt predecessor is
        # still unusable — surface it on the dependent step too
        bad = [b for b in bad if b != s]
        if bad:
            chain_problems[s] = Problem(
                s, mf.manifest_key(s), "broken-chain",
                f"chain depends on corrupt step(s) {bad}")
    return ScanReport(steps=reports, chain_problems=chain_problems, deep=deep)


# ------------------------------------------------------------- quarantine

def quarantine_key(step: int, orig_key: str) -> str:
    return f"{CORRUPT_PREFIX}ckpt_{step:012d}/{orig_key}"


def reason_key(step: int) -> str:
    return f"{CORRUPT_PREFIX}ckpt_{step:012d}/REASON.json"


def quarantined_steps(store: ObjectStore) -> List[int]:
    """Steps currently parked under ``corrupt/``."""
    steps = set()
    for key in store.list(CORRUPT_PREFIX):
        name = key[len(CORRUPT_PREFIX):]
        if not name.startswith("ckpt_"):
            continue
        digits = name[len("ckpt_"):].split("/", 1)[0]
        if digits.isdigit():
            steps.add(int(digits))
    return sorted(steps)


def quarantine_step(store: ObjectStore, step: int, reason: str,
                    problems: Optional[List[Problem]] = None) -> List[str]:
    """Move one step's blobs under ``corrupt/ckpt_<step>/`` (original keys
    preserved below that prefix, so un-quarantining is a reverse move) and
    record why in ``REASON.json``.

    The MANIFEST moves first: the step stops being "committed" before any
    payload blob moves, so a concurrent reader either sees the intact step
    or no step at all — never a committed manifest with half its chunks
    gone. Returns the moved keys."""
    moved: List[str] = []
    man_key = mf.manifest_key(step)
    if store.exists(man_key):
        store.move(man_key, quarantine_key(step, man_key))
        moved.append(man_key)
    for prefix in (mf.part_prefix(step), mf.chunk_prefix(step)):
        for key in list(store.list(prefix)):
            store.move(key, quarantine_key(step, key))
            moved.append(key)
    record = dict(
        step=step,
        reason=reason,
        quarantined_unix=time.time(),
        moved_keys=len(moved),
        problems=[p.to_dict() for p in (problems or [])],
    )
    store.put(reason_key(step),
              json.dumps(record, indent=1, sort_keys=True).encode())
    return moved


# ---------------------------------------------------------- resume planning

@dataclasses.dataclass
class ResumePlan:
    """Where training can restart after corruption.

    ``latest_valid``     newest step whose whole recovery chain is
                         structurally complete (manifests + blobs present
                         at their recorded sizes).
    ``last_known_good``  newest step whose whole chain is content-verified
                         (crc32 + hash32 of every blob). Only differs from
                         ``latest_valid`` when the scan ran quick — a deep
                         scan's structural pass IS content-verified, and a
                         quick scan cannot certify content, so the field
                         is ``None`` unless the scan was deep.
    """

    latest_step: Optional[int]
    latest_valid: Optional[int]
    last_known_good: Optional[int]
    corrupt_steps: List[int]
    reasons: Dict[int, str]
    deep: bool

    @property
    def resume_step(self) -> Optional[int]:
        return (self.last_known_good if self.last_known_good is not None
                else self.latest_valid)


_STRUCTURAL_KINDS = frozenset({
    "manifest-unreadable", "missing-chunk", "missing-dense",
    "size-mismatch", "missing-part",
})


def plan_resume(store: ObjectStore,
                report: Optional[ScanReport] = None,
                deep: bool = True) -> ResumePlan:
    """Build a :class:`ResumePlan` from a scan (running one if not given).

    A step is a resume candidate only if every manifest in its recovery
    chain scans clean — corruption anywhere upstream poisons everything
    replayed on top of it."""
    if report is None:
        report = scan_store(store, deep=deep)
    steps_desc = sorted(report.steps, reverse=True)
    latest = steps_desc[0] if steps_desc else None

    def chain_ok(s: int, kinds: Optional[frozenset]) -> bool:
        if s in report.chain_problems:
            return False
        try:
            chain = checked_chain(store, s)
        except ChunkCorruptionError:
            return False
        for m in chain:
            rep = report.steps.get(m.step)
            if rep is None:
                rep = scan_step(store, m.step, deep=report.deep)
                report.steps[m.step] = rep
            fatal = rep.fatal_problems
            if kinds is not None:
                fatal = [p for p in fatal if p.kind in kinds]
            if fatal:
                return False
        return True

    latest_valid = next(
        (s for s in steps_desc if chain_ok(s, _STRUCTURAL_KINDS)), None)
    last_known_good = (next((s for s in steps_desc if chain_ok(s, None)),
                            None) if report.deep else None)
    reasons: Dict[int, str] = {}
    for s in report.corrupt_steps:
        ps = report.steps[s].fatal_problems
        reasons[s] = "; ".join(f"{p.kind} {p.key}" for p in ps[:4])
        if len(ps) > 4:
            reasons[s] += f" (+{len(ps) - 4} more)"
    for s, p in report.chain_problems.items():
        reasons.setdefault(s, f"{p.kind}: {p.detail}")
    return ResumePlan(latest_step=latest, latest_valid=latest_valid,
                      last_known_good=last_known_good,
                      corrupt_steps=sorted(set(report.corrupt_steps)
                                           | set(report.chain_problems)),
                      reasons=reasons, deep=report.deep)
