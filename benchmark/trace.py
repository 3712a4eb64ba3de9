"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: device busy time (the union of kernels, copies and
sets on the card), device time under each forward label, the device
operations that took most time, and the idle gaps by what the host was
doing (the harness's ``bm.*`` spans on the calling thread).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

NET_LABELS = ("PileupNet.forward", "FullAlignmentNet.forward")
# innermost first: a gap inside a stage is that stage's, else the pass's
HOST_SPANS = ("bm.phase", "bm.pileup", "bm.full_alignment", "bm.write_vcf",
              "bm.engine", "bm.pass")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(prof, window_ns: Tuple[int, int]) -> Dict:
    """``window_ns`` is the (start, end) of the window on the profiler's
    clock (the ``bm.window`` span).

    A net's device time is that of every kernel on the CUDA streams its
    label was seen on, on the device side of the trace: each engine runs
    its net on a stream of its own, and the pileup kernels, launched from
    a library of their own, carry no torch operator to correlate them
    by.  Copies on those streams are the engine's, not the net's."""
    events = prof.profiler.kineto_results.events()
    w0, w1 = window_ns
    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = defaultdict(float)
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    streams: Dict[str, set] = defaultdict(set)
    per_stream: Dict[int, float] = defaultdict(float)
    label_calls: Dict[str, int] = defaultdict(int)
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_device = "CUDA" in str(ev.device_type())
        if name in NET_LABELS:
            if on_device:
                streams[name].add(ev.device_resource_id())
            elif w0 <= s < w1:
                label_calls[name] += 1
            continue
        if not on_device:
            if name in HOST_SPANS:
                spans[name].append((s, e))
            continue
        if ev.is_user_annotation() or name.startswith("bm."):
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        dev.append((s, e))
        by_name[name] += (e - s) / 1e9
        if not _is_copy(name):
            per_stream[ev.device_resource_id()] += (e - s) / 1e9
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) / 1e9

    # idle gaps, each given to the innermost host span at its middle
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: Dict[str, float] = defaultdict(float)
    if gaps:
        g = np.array(gaps, dtype=np.int64)
        mid = (g[:, 0] + g[:, 1]) // 2
        length = (g[:, 1] - g[:, 0]) / 1e9
        owner = np.full(len(g), -1)
        for k, name in enumerate(HOST_SPANS):
            iv = sorted(spans.get(name, []))
            if not iv:
                continue
            starts = np.array([a for a, _ in iv], dtype=np.int64)
            ends = np.array([b for _, b in iv], dtype=np.int64)
            idx = np.searchsorted(starts, mid, side="right") - 1
            inside = (idx >= 0) & (mid < ends[np.clip(idx, 0, None)])
            owner = np.where((owner < 0) & inside, k, owner)
        for k, sec in zip(owner, length):
            idle[HOST_SPANS[k] if k >= 0 else "outside a pass"] += float(sec)

    label_device_s: Dict[str, float] = {}
    for label in NET_LABELS:
        if streams.get(label):
            label_device_s[label] = sum(per_stream[st] for st in streams[label])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "label_device_s": label_device_s,
        "label_calls": dict(label_calls),
        "streams": {k: sorted(v) for k, v in streams.items()},
        "stream_kernel_s": dict(per_stream),
        "device_ops": [[n[:160], v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def window_bounds(prof, label: str = "bm.window") -> Tuple[int, int]:
    for ev in prof.profiler.kineto_results.events():
        if ev.name() == label and "CPU" in str(ev.device_type()):
            return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    raise RuntimeError(f"no {label} span in the trace")
