"""The GPU profiler-trace reduction (utils/profiling.py) on a small
synthetic trace in the format jax.profiler writes for a GPU run."""
import gzip
import json

import pytest

from tpu_pathtracer.utils import profiling


def _trace(tmp_path):
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "/device:GPU:1"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
    ]

    def ev(pid, ts, dur, name, op=None):
        e = {"ph": "X", "pid": pid, "tid": 13, "ts": ts, "dur": dur,
             "name": name, "args": {}}
        if op:
            e["args"]["hlo_op"] = op
        return e
    events = meta + [
        # the FFI traversal kernel (outside any command buffer)
        ev(1, 100.0, 10.0,
           "void (anonymous namespace)::trace_kernel<false>(Rays)",
           "ffi_call.0"),
        # a scatter fusion inside a CUDA graph, overlapping the trace
        ev(1, 105.0, 10.0, "input_scatter_fusion_50", "command_buffer"),
        ev(1, 118.0, 2.0,
           "void cub::DeviceRadixSortOnesweepKernel<...>", "custom-call.4"),
        ev(1, 121.0, 1.0, "memcpy32_post", "command_buffer"),
        ev(1, 122.0, 3.0, "fusion_794", "command_buffer"),
        ev(2, 0.0, 500.0, "fusion_1", "command_buffer"),     # other GPU
        ev(9, 0.0, 900.0, "python"),                         # host
    ]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_gpu_trace_reduction(tmp_path):
    events = profiling.load_trace(_trace(tmp_path))
    dev = profiling.device_events(events)
    assert len(dev) == 5                      # GPU:0 only, "X" events only
    s = profiling.summarize(dev)
    assert s["window_ms"] == pytest.approx(0.025)      # 100 .. 125 us
    assert s["busy_ms"] == pytest.approx(0.021)        # 100-115, 118-125
    assert s["idle_share"] == pytest.approx(4.0 / 25.0)
    assert s["by_category_ms"] == pytest.approx({
        "trace": 0.010, "image_scatter": 0.010, "sort": 0.002,
        "copies": 0.001, "other": 0.003})
    assert len(profiling.device_events(events, device=1)) == 1
    with pytest.raises(ValueError):
        profiling.device_events(events, device=3)
