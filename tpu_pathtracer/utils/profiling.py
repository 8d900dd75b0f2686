"""Device time from a jax.profiler trace of a GPU run.

`jax.profiler.trace(logdir)` writes `plugins/profile/<time>/*.trace.json.gz`
(Chrome trace format). On a GPU the device is the process named
`/device:GPU:<n>`; each kernel is an "X" event on one of its stream threads
with `args.hlo_op` (the HLO instruction) and `args.hlo_module`. Host work
is on the `/host:CPU` process and is ignored here.

`summarize` reduces one device's events to: the window (first start to
last end), busy time (union of the kernel intervals), the idle share
(1 - busy / window), and device time by category:

  trace           the CUDA traversal kernel (FFI custom call, hlo_op
                  `ffi_call*` or kernel `trace_kernel*`)
  image_scatter   scatter fusions (the image accumulation)
  sort            radix-sort kernels (the regen pool's compaction argsort)
  copies          memcpy / memset
  other           everything else: elementwise shading, respawn, and the
                  gathers, which XLA fuses into loop fusions whose names
                  do not say so

Category sums are kernel durations; kernels on different streams may
overlap, so they can add up to more than the busy time.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil

CATEGORIES = ("trace", "image_scatter", "sort", "copies", "other")


def load_trace(logdir):
    """The newest trace.json.gz under logdir, as a list of events."""
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not paths:
        raise FileNotFoundError("no profiler trace under %s" % logdir)
    with gzip.open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def device_events(events, device=0):
    """The "X" events of /device:GPU:<device>."""
    name = "/device:GPU:%d" % device
    pids = {e["pid"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and e.get("args", {}).get("name") == name}
    if not pids:
        raise ValueError("trace has no %s process" % name)
    return [e for e in events if e.get("ph") == "X" and e.get("pid") in pids]


def category(event):
    """Category of one kernel event, from its kernel name and hlo_op.
    Inside a CUDA graph (XLA command buffer) hlo_op is "command_buffer"
    and the kernel name carries the fusion's name."""
    op = event.get("args", {}).get("hlo_op", "")
    kname = event.get("name", "")
    if op.startswith("ffi_call") or "trace_kernel" in kname:
        return "trace"
    if "scatter" in kname or "scatter" in op:
        return "image_scatter"
    if "RadixSort" in kname or "sort" in op:
        return "sort"
    if kname.lower().startswith(("memcpy", "memset")):
        return "copies"
    return "other"


def summarize(events):
    """Window, busy, idle share and per-category time (ms) of one
    device's events."""
    if not events:
        raise ValueError("no device events in the window")
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    by_cat = dict.fromkeys(CATEGORIES, 0.0)
    for e in events:
        by_cat[category(e)] += e.get("dur", 0.0) / 1e3
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "by_category_ms": by_cat, "kernels": len(events)}


def profile_frames(run, logdir):
    """Call run() once to warm up, then once under the profiler; return
    summarize() of GPU 0's events. run() must block until the device is
    done (return an array; it is waited for here)."""
    import jax
    jax.block_until_ready(run())
    shutil.rmtree(logdir, ignore_errors=True)
    with jax.profiler.trace(logdir):
        jax.block_until_ready(run())
    return summarize(device_events(load_trace(logdir)))
