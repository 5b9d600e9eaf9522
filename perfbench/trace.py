"""The reduction of a ``torch.profiler`` run to what the per-layer
metrics read: device busy time (the union of device-event intervals),
each kernel's device time, the time of each kernel class, host-to-device
copies, and the longest idle gaps named by what the host was doing.
Kernel classes are the files of ``kernel_classes/``: a file's stem is
the class, each line a regular expression searched in kernel names."""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

CLASSES_DIR = Path(__file__).resolve().parent / "kernel_classes"


def kernel_classes(folder: Path = CLASSES_DIR) -> Dict[str, List[str]]:
    """{class: [pattern, ...]} of every file in ``folder``."""
    out = {}
    for f in sorted(folder.iterdir()):
        if f.is_file() and not f.name.startswith("."):
            out[f.stem] = [ln.strip() for ln in f.read_text().splitlines()
                           if ln.strip() and not ln.startswith("#")]
    return out


def classify(name: str, classes: Dict[str, List[str]]) -> str:
    """The first class (in file-name order) one of whose patterns the
    kernel's name matches, else ``other``."""
    for cls, patterns in classes.items():
        if any(re.search(p, name, re.IGNORECASE) for p in patterns):
            return cls
    return "other"


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``(start, end)`` microsecond
    intervals (``chip_smoke.py``'s ``device_split`` arithmetic)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e6


def summarize(device_events, host_events, window_s: float,
              classes: Dict[str, List[str]]) -> dict:
    """``device_events`` and ``host_events`` are ``(name, start_us,
    end_us)``; returns the summary the metric readers take."""
    spans = [(a, b) for _, a, b in device_events]
    by_kernel: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    htod = 0.0
    for name, a, b in device_events:
        s = (b - a) / 1e6
        by_kernel[name] += s
        if "HtoD" in name:
            htod += s
        else:
            by_class[classify(name, classes)] += s
    gaps = []
    end = None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inside = [(s, n) for n, s, e in host_events if s <= mid <= e]
        named.append([max(inside)[1] if inside else "no host op",
                      (b - a) / 1e6])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": union_seconds(spans), "window_s": window_s,
            "by_class": dict(by_class), "htod_s": htod,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": named}


class Profiler:
    """``torch.profiler``'s Kineto tracer (CUPTI on the card) over a
    stretch of the run, read from its raw events: the events are not
    turned into Python event trees, which would take minutes for an
    epoch of ResNet-50."""

    def __init__(self):
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState)
        self._acts = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self._acts.add(ProfilerActivity.CUDA)
        self._cfg = ProfilerConfig(ProfilerState.KINETO, False, False,
                                   False, False, False,
                                   _ExperimentalConfig())
        self.result = None

    def __enter__(self):
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self._cfg, self._acts)
        _enable_profiler(self._cfg, self._acts)
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self.result = _disable_profiler()

    def summary(self, window_s: float,
                classes: Dict[str, List[str]]) -> dict:
        """:func:`summarize` of the stretch profiled."""
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.result.events():
            rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
        return summarize(dev, host, window_s, classes)
