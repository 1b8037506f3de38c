"""Serving launcher: batched request loop with live checkpoint refresh.

The paper's *online training* consumer side: an inference process serves
batched requests from a model it refreshes from the newest valid
Check-N-Run checkpoint (full or increment chain) whenever the store's
newest committed step moves — the checkpoint cadence bounds serving
staleness. Each refresh is a full ``restore()``, because the whole model
is rebuilt; replicas that serve embeddings only use the delta subscriber
(``repro_torch.serve``), which pays touched-row bytes per refresh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-rm2|bert4rec \
      --ckpt-dir CKPT_DIR --requests 200 --batch 64 --refresh-every 50 \
      [--reduced | --full-config] [--vocab-cap ROWS] [--device cuda|cpu]

Serves the ``serve_p99`` cell on the card (``--device cuda``, the default)
and raises when there is none; ``--device cpu`` runs the same path on the
CPU. ``--full-config`` and ``--vocab-cap`` must match the train launcher's
flags that wrote the chain, so the tables have the same shapes. dlrm-rm2
answers click probabilities, bert4rec next-item scores for 100 candidates
per request.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm2")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--refresh-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--vocab-cap", type=int, default=None,
                    help="cap every embedding table at this many rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_cell
    from ..core import CheckNRunManager, CheckpointConfig, LocalFSStore
    from ..core import manifest as mf
    from ..data.cells import batch_for_cell
    from ..train.loop import batch_to_device
    from ..train.state import restore_train_state

    # serve_p99 is the online-inference cell of every recsys arch
    bundle = get_cell(args.arch, "serve_p99", reduced=args.reduced,
                      device=args.device, vocab_cap=args.vocab_cap)
    answers = "scores" if args.arch == "bert4rec" else "probabilities"
    store = LocalFSStore(args.ckpt_dir)
    if mf.latest_step(store) is None:
        print(f"no checkpoints in {args.ckpt_dir}; run repro_torch.launch.train first")
        return 1
    mgr = CheckNRunManager(store, CheckpointConfig(device=args.device))

    def load_latest():
        restored = mgr.restore()
        state = restore_train_state(bundle.make_state(), restored, bundle.tracked)
        return state.params, restored.step

    try:
        params, step = load_latest()
        print(f"serving {args.arch} from checkpoint step {step}")
        lat = []
        served = 0
        for i in range(args.requests // args.batch + 1):
            if served and served % args.refresh_every == 0:
                if mf.latest_step(store) != step:
                    params, step = load_latest()
                    print(f"  refreshed to checkpoint step {step} "
                          f"(staleness reset after {served} requests)")
            batch = batch_for_cell(bundle, 50_000 + i)
            t0 = time.monotonic()  # host arrays in, host answers out
            out = bundle.step_fn(params, batch_to_device(batch, bundle.device)).cpu()
            lat.append(time.monotonic() - t0)
            served += int(out.shape[0])
            if served >= args.requests:
                break
    finally:
        mgr.close()
    lat_ms = sorted(1e3 * t for t in lat)
    print(f"served {served} requests in {len(lat)} batches on {bundle.device}; "
          f"p50 {lat_ms[len(lat_ms)//2]:.2f} ms  "
          f"p99 {lat_ms[int(len(lat_ms)*0.99)]:.2f} ms per batch (host arrays "
          f"in, host {answers} out)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
