"""Training launcher CLI.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch xdeepfm|dlrm-rm2|mind|bert4rec|dimenet|qwen2-0.5b|nemotron-4-15b \
      --shape SHAPE --steps 100 --interval 20 --bits 4 \
      --policy intermittent --ckpt-dir CKPT_DIR [--reduced | --full-config] \
      [--vocab-cap ROWS] [--fail-at 60] [--device cuda|cpu]

SHAPE is a train shape of the arch's family: ``train_batch`` (recsys),
``molecule``, ``full_graph_sm``, ``minibatch_lg`` or ``ogb_products``
(dimenet), ``train_4k`` (the LMs).

Runs on the card (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the same path on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="xdeepfm, dlrm-rm2, mind, bert4rec, dimenet, qwen2-0.5b "
                         "or nemotron-4-15b")
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--interval", type=int, default=20)
    ap.add_argument("--policy", default="intermittent",
                    choices=["full_only", "one_shot", "consecutive", "intermittent"])
    ap.add_argument("--bits", type=int, default=4, choices=[0, 2, 3, 4, 8],
                    help="0 = no quantization")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--vocab-cap", type=int, default=None,
                    help="cap every embedding table at this many rows")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--n-nodes", type=int, default=1)
    ap.add_argument("--p-fail", type=float, default=0.0)
    ap.add_argument("--train-hours", type=float, default=24.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_cell
    from ..core import CheckpointConfig, InMemoryStore, LocalFSStore, PAPER_DEFAULTS
    from ..core.bitwidth import BitwidthController
    from ..train.loop import SimulatedFailure, Trainer, TrainerConfig

    bundle = get_cell(args.arch, args.shape, reduced=args.reduced,
                      device=args.device, vocab_cap=args.vocab_cap)

    store = LocalFSStore(args.ckpt_dir) if args.ckpt_dir else InMemoryStore()
    bitwidth = None
    if args.p_fail > 0:
        bitwidth = BitwidthController(args.n_nodes, args.p_fail, args.train_hours)
        print(f"dynamic bit-width: E[failures]={bitwidth.estimate:.2f} → "
              f"{bitwidth.bits}-bit")
    quant = None if args.bits == 0 else PAPER_DEFAULTS[args.bits]
    ckpt = CheckpointConfig(interval_batches=args.interval, policy=args.policy,
                            quant=quant, async_write=True, device=args.device)
    trainer = Trainer(bundle, store, ckpt,
                      TrainerConfig(total_steps=args.steps, log_every=10),
                      bitwidth=bitwidth)
    start = trainer.init_or_restore()
    if start:
        print(f"resumed from checkpoint at step {start}")
    try:
        trainer.run(args.steps - start, fail_at_step=args.fail_at)
    except SimulatedFailure as e:
        print(f"!! {e} — rerun this command to resume from the checkpoint")
        trainer.close()
        return 2
    trainer.manager.wait()
    for m in trainer.history:
        print("  " + "  ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in m.items()))
    stats = store.counters.snapshot()
    print(f"checkpoint bytes written: {stats['bytes_written']/1e6:.2f} MB "
          f"({stats['put_ops']} objects)")
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
