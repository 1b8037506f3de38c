"""95th percentile (linear between ranks) of the window's step times, each
the device time between CUDA events recorded after consecutive steps on
their stream (read after the window): a stall or a wait lands in the step
that follows it."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if len(run.step_ms) >= 20 else None
