"""The kernels' roofline shares read the work from the chunks' shapes and
the time from every launch in the trace, so how the work is split into
launches cannot move them; a trace that lost a launch's device record
gives no share."""

import types

import pytest

from cnr_bench import devtrace
from cnr_bench.bench import load_reader
from cnr_bench.roofline import kernel_share

CHUNKS = [(65536, 64, 4)] * 6


def _run(kernels, lost=0, chunks=CHUNKS):
    trace = dict(kernels=kernels, lost_launches=lost)
    return types.SimpleNamespace(trace=trace, traced_saves=[dict(chunks=list(chunks))])


def _bound(chunk):
    return chunk[0] * 1e-9


@pytest.mark.parametrize("launches", [1, 3, 6, 12])
def test_the_share_does_not_depend_on_how_the_work_is_launched(launches):
    total_ns = 6 * 131072.0
    run = _run([("quant_pack_kernel", total_ns / launches)] * launches + [("other", 5e6)])
    assert kernel_share(run, "quant_pack", _bound) == pytest.approx(50.0)


def test_twice_the_launches_for_the_same_work_halve_the_share():
    once = _run([("quant_pack_kernel", 131072.0)] * 6)
    twice = _run([("quant_pack_kernel", 131072.0)] * 12)
    assert kernel_share(twice, "quant_pack", _bound) == pytest.approx(
        kernel_share(once, "quant_pack", _bound) / 2)


@pytest.mark.parametrize("lost", [1, None])
def test_a_trace_that_lost_launches_or_cannot_tell_gives_no_share(lost):
    run = _run([("quant_pack_kernel", 131072.0)] * 6, lost=lost)
    assert kernel_share(run, "quant_pack", _bound) is None


def test_no_launch_or_no_chunk_gives_no_share():
    assert kernel_share(_run([("other", 1.0)]), "quant_pack", _bound) is None
    assert kernel_share(_run([("quant_pack_kernel", 1.0)], chunks=[]), "quant_pack", _bound) is None


class _Ev:
    def __init__(self, name, cuda, corr, linked=0):
        self._n, self._cuda, self._c, self._l = name, cuda, corr, linked

    def name(self):
        return self._n

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_ns(self):
        return 0

    def duration_ns(self):
        return 10


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))


def test_launches_are_matched_to_their_device_records_by_correlation():
    events = [_Ev("cudaLaunchKernel", False, 1), _Ev("k1", True, 1),
              _Ev("cuLaunchKernel", False, 2), _Ev("k2", True, 0, linked=2),
              _Ev("cudaLaunchKernel", False, 3), _Ev("cudaMemcpyAsync", False, 4),
              _Ev("Memcpy DtoH", True, 4)]
    out, lost = devtrace._device_events(_prof(events))
    assert [n for n, _, _ in out] == ["k1", "k2", "Memcpy DtoH"]
    assert lost == 1
    _, lost = devtrace._device_events(_prof(events[:4]))
    assert lost == 0
    _, lost = devtrace._device_events(_prof([_Ev("k1", True, 1)]))
    assert lost is None


@pytest.mark.parametrize("metric", ["save_commit_s.dlrm-rm2", "save_commit_s.xdeepfm"])
def test_the_commit_age_is_the_mean_over_the_windows_saves(metric):
    read = load_reader(metric).read
    run = types.SimpleNamespace(saves=[dict(t_start=1.0, t_commit=4.0), dict(t_start=10.0, t_commit=11.0)])
    assert read(run) == pytest.approx(2.0)
    assert read(types.SimpleNamespace(saves=[])) is None


@pytest.mark.parametrize("metric", ["snapshot_stall_s.dlrm-rm2", "snapshot_stall_s.xdeepfm"])
def test_the_stall_is_the_mean_over_the_windows_saves(metric):
    read = load_reader(metric).read
    assert read(types.SimpleNamespace(stalls=[0.5, 1.5])) == pytest.approx(1.0)
    assert read(types.SimpleNamespace(stalls=[])) is None
