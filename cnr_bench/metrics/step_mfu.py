"""The whole step's share of the card's bf16 peak (989 TFLOP/s, dense):
3 x the configuration's analytic forward FLOPs of a batch (its plain
reference's ``dense_flops``) x the steps of the window, over the window's
seconds and the peak, in %."""

from cnr_bench.roofline import PEAK_BF16_FLOPS


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    flops = 3.0 * run.ref.dense_flops(run.cfg, int(run.traffic["batch"])) * run.steps
    return 100.0 * flops / run.window_s / PEAK_BF16_FLOPS
