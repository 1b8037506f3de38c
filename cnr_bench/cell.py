"""One run of a training cell: the program (``repro_torch``) trains a
configuration through ``Trainer.run`` with its Check-N-Run saves, under a
traffic mix, from a seed.

Set-up makes the weights on the card from the seed (``weights``), hands
them to the program's state, drives its first steps through
``Trainer.run`` (their losses, the first gradient's norms read from the
optimizer state after one step, and the parameters' change after the
checked steps are kept for the comparison), and runs to the first
checkpoint boundary, whose (full) save commits before the window. The
window then drives ``Trainer.run`` a step at a time (a save starts inside
the call that ends an interval) until its seconds have passed. After it
the save in flight is waited for, the peak memory read, the program's
state freed, and the run judged against the plain references
(``reference/``). A traffic mix whose ``interval_batches`` is 0 trains
with no save at all, and is judged on its steps alone.

The harness's own spans around the calls into the program (a step, a
checkpoint's snapshot, its wait for the previous save) feed the metrics
(``metrics/``) and, in a traced run, name the device's idle gaps.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import gen
from . import devtrace as tracing
from .bench import load_reference
from .reference import chunks as ref_chunks
from .reference import train as ref_train
from .weights import leaves_of, make_weights, nest

# What the check compares, the same in every cell: the steps whose loss,
# first gradient and change are held to the reference, the chunks of the
# last save decoded, and the reference's rows a block.
CHECKED_STEPS = 3
CHECKED_CHUNKS = 16
REFERENCE_BLOCK_ROWS = 8192


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers."""

    cfg: dict
    traffic: dict
    ref: Any
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    samples: int = 0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    stalls: List[float] = dataclasses.field(default_factory=list)
    saves: List[dict] = dataclasses.field(default_factory=list)        # committed in the window
    traced_saves: List[dict] = dataclasses.field(default_factory=list)  # started in the window
    window_bytes: int = 0
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    failed_saves: int = 0
    checks: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


def build_program(cfg: dict, traffic: dict, device: str):
    """The program's cell bundle for a configuration file: its config class
    filled from the file's sizes, its cell builder at the traffic's batch."""
    prog = cfg["program"]
    mod, cls = prog["config_class"].split(":")
    klass = getattr(importlib.import_module(mod), cls)
    kw = {}
    for f in dataclasses.fields(klass):
        if f.name == "name":
            kw["name"] = cfg["name"]
        elif f.name == "compute_dtype" and f.name in cfg:
            kw[f.name] = getattr(torch, cfg[f.name])
        elif f.name in cfg:
            v = cfg[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    mod, fn = prog["cell"].split(":")
    cell = getattr(importlib.import_module(mod), fn)
    return cell(prog["arch"], klass(**kw), prog["shape"], device=device,
                global_batch=int(traffic["batch"]))


class _Clock:
    """Marks after each step: CUDA events on the card (read after the
    window), the host clock elsewhere."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def _grad_norms(opt_state, tracked) -> Dict[tuple, float]:
    """Each leaf's first gradient's norm, from AdaGrad's state after one
    step from zero: row-wise, ``acc = mean(g²)`` a row (``dim`` values);
    elementwise, ``acc = g²``."""
    out = {}
    for path, acc in leaves_of(opt_state):
        s = float(acc.detach().double().sum())
        if path[0] == "tables":
            s *= tracked[path[1]].dim
        out[path] = math.sqrt(max(s, 0.0))
    return out


def _selection_wrong(saves: List[dict], ref, cfg: dict, stream) -> int:
    """Rows wrong in the row selection of every committed save: a full
    save's chunks have to tile each table; an increment (the intermittent
    policy's are cumulative) has to hold exactly the rows the batches
    since its base touched, regenerated from the seed."""
    from concurrent.futures import ThreadPoolExecutor

    tabs = ref.tables(cfg)
    wrong, base, upto, masks = 0, None, None, {}
    with ThreadPoolExecutor(4) as pool:
        for s in sorted(saves, key=lambda s: s["step"]):
            if s["kind"] == "full":
                wrong += ref_chunks.full_rows_wrong(s["manifest"])
                continue
            if s["base_step"] != base:
                base = upto = s["base_step"]
                masks = {f: np.zeros(int(v), bool) for f, v in enumerate(cfg["vocab_sizes"])}
            for ids in pool.map(lambda i: gen.recsys_ids(stream, i), range(upto, s["step"])):
                for f, m in masks.items():
                    m[ids[:, f, :].reshape(-1)] = True
            upto = s["step"]
            rows = {f: np.flatnonzero(m) for f, m in masks.items()}
            stored = ref_chunks.stored_rows(s["payloads"].__getitem__, s["manifest"])
            wrong += ref_chunks.selection_wrong(stored, {name: rows[f] for name, f in tabs})
    return wrong


def checkpoint_config(traffic: dict, device: str):
    """The program's checkpoint settings for a traffic mix; one whose
    ``interval_batches`` is 0 never saves and names none."""
    from repro_torch.core.checkpoint import CheckpointConfig
    from repro_torch.core.quantize import QuantConfig

    if not int(traffic["interval_batches"]):
        return CheckpointConfig(interval_batches=1 << 40, device=device)
    return CheckpointConfig(
        interval_batches=int(traffic["interval_batches"]), policy=traffic["policy"],
        quant=QuantConfig(**traffic["quant"]), async_write=bool(traffic["async_write"]),
        overlap=traffic["overlap"], chunk_rows=int(traffic["chunk_rows"]), device=device)


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", on_window_end: Callable = lambda: None,
             block_rows: int = REFERENCE_BLOCK_ROWS) -> Run:
    """One run of the cell; ``on_window_end`` is called once the window
    has closed (the harness's check of what the process has imported);
    ``block_rows`` is the reference's rows a block."""
    from repro_torch.core.storage import InMemoryStore
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.state import init_train_state, rng_key_data

    ref = load_reference(cfg["name"])
    run = Run(cfg=cfg, traffic=traffic, ref=ref)
    cuda = device == "cuda"
    clock = _Clock(cuda)
    ckpt_cfg = checkpoint_config(traffic, device)
    interval = ckpt_cfg.interval_batches
    saving = bool(int(traffic["interval_batches"]))
    checked = CHECKED_STEPS

    bundle = build_program(cfg, traffic, device)
    specs = ref.param_specs(cfg)
    leaves = make_weights(specs, seed, bundle.device)
    want = {p: tuple(x.shape) for p, x in leaves_of(bundle.params_shapes())}
    have = {p: tuple(x.shape) for p, x in leaves.items()}
    if want != have:
        raise RuntimeError(f"the reference's parameters are not the program's: "
                           f"{sorted(set(want.items()) ^ set(have.items()), key=repr)[:8]}")
    box = [init_train_state(nest(leaves), bundle.optimizer, bundle.tracked,
                            rng_key_data(1), bundle.device)]
    del leaves
    bundle.make_state = lambda seed=0: box.pop()

    spans: Optional[list] = [] if trace else None
    marks: list = []
    losses: list = []
    step_fn = bundle.step_fn

    def step(state, batch):
        t0 = time.time_ns()
        new, metrics = step_fn(state, batch)
        marks.append(clock.mark())
        if len(losses) < checked:
            losses.append(metrics["loss"].detach().clone())
        if spans is not None:
            spans.append(("step", t0, time.time_ns()))
        return new, metrics

    bundle.step_fn = step

    store = InMemoryStore()
    stream = gen.stream_config(cfg, traffic, seed)
    trainer = Trainer(bundle, store, ckpt_cfg,
                      TrainerConfig(total_steps=interval, log_every=1 << 62),
                      batch_fn=lambda i: gen.batch_for(stream, i))

    saves: List[dict] = []
    snaps: Dict[int, Any] = {}
    now: Dict[str, int] = {}
    checkpoint, save = trainer.checkpoint, trainer.manager.save

    def on_done(rec, fut):
        try:
            fut.result()
            man = ref_chunks.load_manifest(store.get, rec["step"])
        except BaseException as e:  # a failed save fails the run
            rec["error"] = repr(e)
        else:
            rec.update(t_commit=man["created_unix"], kind=man["kind"], base_step=man["base_step"],
                       bytes_written=store.counters.snapshot()["bytes_written"],
                       chunks=[(c["n_rows"], t["dim"], t["bits"])
                               for t in man["tables"].values() for c in t["chunks"]])
            # what the selection is judged by, held (not copied) before a
            # later save's retention deletes the chunks, read after the window
            rec["manifest"] = man
            if man["kind"] != "full":
                rec["payloads"] = {c["key"]: store.get(c["key"])
                                   for t in man["tables"].values() for c in t["chunks"]}
        saves.append(rec)

    def traced_checkpoint():
        now["t"], now["ns"] = time.time(), time.time_ns()
        checkpoint()

    def traced_save(snap, block=False):
        t_call = time.time_ns()
        rec = dict(step=snap.step, t_start=now["t"], stall_s=trainer.stall_times[-1])
        snaps[snap.step] = snap
        for s in sorted(snaps)[:-2]:
            del snaps[s]
        fut = save(snap, block)
        if spans is not None:
            spans.append(("checkpoint.snapshot", now["ns"], t_call))
            spans.append(("checkpoint.wait_for_previous_save", t_call, time.time_ns()))
        fut.add_done_callback(lambda f: on_done(rec, f))
        return fut

    trainer.checkpoint = traced_checkpoint
    trainer.manager.save = traced_save

    # ---- set-up: the checked steps, then the first boundary's full save
    trainer.init_or_restore()
    trainer.run(1)
    prog_grad = _grad_norms(trainer.state.opt_state, bundle.tracked)
    if checked > 1:
        trainer.run(checked - 1)
    w0 = make_weights(specs, seed, bundle.device)
    prog_change = {p: float(torch.linalg.vector_norm(x.detach() - w0[p]))
                   for p, x in leaves_of(trainer.state.params)}
    del w0
    prog_losses = [float(x) for x in losses]
    boundary = -(-checked // interval) * interval
    if saving and boundary > checked:
        trainer.run(boundary - checked)
    trainer.manager.wait()
    clock.sync()

    # ---- the window
    n_marks, n_stalls, n_saves = len(marks), len(trainer.stall_times), len(saves)
    bytes0 = store.counters.snapshot()["bytes_written"]
    prof = None
    if trace:
        prof, marker_ns = tracing.start()
    start = clock.mark()
    run.setup_s = _process_age()
    t0, t0_ns = time.time(), time.time_ns()
    while time.time() - t0 < seconds:
        trainer.run(1)
    clock.sync()
    t1, t1_ns = time.time(), time.time_ns()
    on_window_end()

    run.window_s = t1 - t0
    window_marks = [start] + marks[n_marks:]
    run.steps = len(window_marks) - 1
    run.samples = run.steps * int(traffic["batch"])
    run.step_ms = [clock.ms(a, b) for a, b in zip(window_marks[:-1], window_marks[1:])]
    run.stalls = list(trainer.stall_times[n_stalls:])
    t_tail = time.monotonic()
    try:
        trainer.manager.wait()
    finally:
        if prof is not None:
            prof.stop()
    clock.sync()
    done = sorted(saves[n_saves:], key=lambda s: s["step"])
    run.failed_saves = sum("error" in s for s in saves)
    run.traced_saves = [s for s in done if "error" not in s]
    run.saves = [s for s in run.traced_saves if s["t_commit"] <= t1]
    if run.saves:
        run.window_bytes = run.saves[-1]["bytes_written"] - bytes0
    if prof is not None:
        run.trace = tracing.read(prof, marker_ns, t0_ns, t1_ns, spans)
        del prof
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0

    # ---- free the program's state; judge its outputs
    trainer.close()
    trainer.state = None
    del trainer, bundle, box
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    if saving and not run.failed_saves:
        last = max(saves, key=lambda s: s["step"])
        checks["rows_wrong"] = float(_selection_wrong(saves, ref, cfg, stream))
        n_q = ref_chunks.n_quantized_chunks(store.get, last["step"])
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
        sample = rng.choice(n_q, size=min(CHECKED_CHUNKS, n_q), replace=False)
        checks.update(ref_chunks.check_save(store.get, last["step"], snaps[last["step"]],
                                            sample.tolist(), device))
    del store, snaps
    gc.collect()
    t_ref = time.monotonic()
    batches = [gen.batch_for(stream, i) for i in range(checked)]
    want = ref_train.reference_steps(ref, cfg, seed, batches, device,
                                     block_rows=block_rows)
    prog = dict(losses=prog_losses, grad=prog_grad, change=prog_change)
    checks.update(ref_train.gaps(prog, want))
    run.detail = ref_train.detail(prog, want)
    run.detail["tail_s"] = dict(wait_and_checks=t_ref - t_tail, reference=time.monotonic() - t_ref)
    limits = {k: v for k, v in cfg["limits"].items() if saving or k in ref_train.STEP_CHECKS}
    run.checks = {k: (float(checks.get(k, math.inf)), float(limits[k])) for k in limits}
    return run


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the system's uptime)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
