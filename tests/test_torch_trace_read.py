"""``perf/trace_read.py::device_rows``, the reader behind
``chip_smoke.py``'s kernel tables: on records made up here, the rows
``key_averages()`` keeps (device records not named after a CPU op, summed
by name, largest first); on a real CPU-only trace, no rows."""

import types

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from clip_finegrained_alignment_tpu_torch.perf.trace_read import device_rows


def _record(name, device, start_us, end_us):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: device,
        start_ns=lambda: start_us * 1000, end_ns=lambda: end_us * 1000)


def _prof(records):
    results = types.SimpleNamespace(events=lambda: records)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_device_rows_keep_kernels_by_name():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    rows = device_rows(_prof([
        _record("aten::mm", cpu, 0, 50),
        _record("cudaLaunchKernel", cpu, 10, 12),
        _record("aten::mm", cuda, 20, 45),            # annotation: dropped
        _record("gemm_kernel", cuda, 20, 30),
        _record("gemm_kernel", cuda, 31, 45),
        _record("Memcpy HtoD", cuda, 0, 5),
        _record("attention_fwd_mma<64>", cuda, 50, 80),
        _record("empty_kernel", cuda, 90, 90),         # no time: dropped
    ]))
    assert rows == [(30.0, "attention_fwd_mma<64>", 1),
                    (24.0, "gemm_kernel", 2), (5.0, "Memcpy HtoD", 1)]


def test_device_rows_of_a_cpu_trace_are_empty():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    assert device_rows(prof) == []
