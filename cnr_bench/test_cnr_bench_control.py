"""The control at a size a test can hold: the plain reference in the
program's place, computed in fp8 (the precision below the configuration's
bf16), and the reference on half of each batch, each against the reference:
each has to fail the limits. At the tests' widths dlrm-rm2's fp8 control
reads about what sound runs read (gradient 0.09-0.23 against 0.02-0.09), so
its control is shown at the cell's own size on the card
(``control.py``), and here the fp8 control of xdeepfm (loss 0.02-0.04
against at most 0.0052) and the half batch of both."""

import pytest

from cnr_bench import gen
from cnr_bench.bench import load_reference
from cnr_bench.cell import CHECKED_STEPS
from cnr_bench.reference import train as rt
from cnr_bench.test_cnr_bench_faults import tiny


@pytest.mark.parametrize("name,how", [("xdeepfm", "fp8"), ("dlrm-rm2", "half_batch"),
                                      ("xdeepfm", "half_batch")])
def test_the_control_fails_the_cells_limits(name, how):
    cfg, traffic = tiny(name)
    ref = load_reference(name)
    seed = 2**32 + 41
    stream = gen.stream_config(cfg, traffic, seed)
    batches = [gen.batch_for(stream, i) for i in range(CHECKED_STEPS)]
    want = rt.reference_steps(ref, cfg, seed, batches, "cpu", block_rows=100)
    kw = dict(lp=rt.fp8) if how == "fp8" else dict(half_batch=True)
    got = rt.gaps(rt.reference_steps(ref, cfg, seed, batches, "cpu", block_rows=100, **kw), want)
    assert any(got[k] > cfg["limits"][k] for k in got), got
