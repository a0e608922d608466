"""The device trace of a `--trace 1` window: `torch.profiler` over the
window, read back from its chrome trace (written under TMPDIR, read and
deleted at once).

From it: the seconds some operation ran on the device (the union of
kernel, copy and set intervals), device time by kernel name, and the
idle gaps between device work labelled by the innermost host span open
over each gap. Host spans are the harness's own intervals on the host's
`perf_counter` (any thread), put on the trace's clock through one
anchor span the window opens with.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN_CAT = "user_annotation"
ANCHOR = "benchmark-trace-anchor"
# the two forms of the bisection kernel, by their demangled or mangled
# names: B1 the mean form, B2 the tail form
KERNEL_FORMS = (
    ("B1", re.compile(r"bisect_(?:small|long)(?:<float, false>|IfLb0E)")),
    ("B2", re.compile(r"bisect_(?:small|long)(?:<float, true>|IfLb1E)")),
)


class DeviceTrace:
    """Context manager around a window; `summary()` after it closes."""

    def __init__(self, device_type: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device_type = device_type
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0
        self.events: list = []

    def __enter__(self):
        self.prof.__enter__()
        with torch.profiler.record_function(ANCHOR):
            self.anchor = time.perf_counter()
        self.t0 = self.anchor
        return self

    def __exit__(self, *exc):
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return False

    def summary(self, host_spans=()) -> dict:
        """host_spans: [(perf_counter start, end, label)]."""
        dev, offset = [], None
        for e in self.events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            a, d = float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                dev.append((a, a + d, e.get("name", "")))
            elif cat == HOST_SPAN_CAT and e.get("name") == ANCHOR:
                offset = a - self.anchor * 1e6
        spans = ([(a * 1e6 + offset, b * 1e6 + offset, n)
                  for a, b, n in host_spans] if offset is not None else [])
        spans.sort()
        by_name: dict[str, float] = {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        forms = {form: sum(s for n, s in by_name.items() if pat.search(n))
                 for form, pat in KERNEL_FORMS}
        merged = []
        for a, b, _n in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_s = sum(b - a for a, b in merged) * 1e-6
        gaps: dict[str, float] = {}
        if offset is not None:
            starts = [a for a, _b, _n in spans]
            lo = self.t0 * 1e6 + offset
            hi = lo + self.window_s * 1e6
            merged = [[max(a, lo), min(b, hi)] for a, b in merged
                      if b > lo and a < hi]
            edges = [lo] + [x for ab in merged for x in ab] + [hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b <= a:
                    continue
                mid = 0.5 * (a + b)
                open_spans = [s for s in spans[:bisect.bisect_right(
                    starts, mid)] if s[1] >= mid]
                label = (min(open_spans, key=lambda s: s[1] - s[0])[2]
                         if open_spans else "between spans")
                gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy_s,
            "window_s": self.window_s,
            "kernel_s": forms,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]],
            "events": len(dev),
        }
