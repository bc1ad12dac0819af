"""The traced run's device timeline and the program's spans.

``torch.profiler`` records CUDA activity only (kernels, copies, sets; no
CPU operators, shapes or stacks). Beside it the benchmark chains an
observer onto the port's span tracer (``obs.tracer``), which the daemon
already feeds with every completed span, and keeps the spans that end in
the window. Both clocks are put on the wall clock (``time.time_ns``),
which is the one the profiler's timestamps use.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Tuple

Interval = Tuple[int, int]


def short_name(name: str) -> str:
    """A device operation's name without its argument list, return type
    or ``(anonymous namespace)::``, at most 96 characters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:96] or "(no name)"


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Start before the window, stop after it; then read ``ops``
    (``(name, start_ns, end_ns, meta)``), ``spans`` (``(name, start_ns,
    end_ns, thread)``) and the window ``t0_ns`` / ``t1_ns``."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, int, int, str]] = []
        self.spans: List[Tuple[str, int, int, str]] = []
        self.t0_ns = self.t1_ns = 0
        self._prof: Any = None
        self._prev: Any = None
        self._off = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from kafkabalancer_tpu_torch import obs

        self._off = time.time_ns() - time.perf_counter_ns()
        self._prev = obs.tracer._observer
        spans, prev, off = self.spans, self._prev, self._off

        def observe(sp: Any) -> None:
            if prev is not None:
                prev(sp)
            if sp.t1_ns is not None:
                spans.append((sp.name, sp.t0_ns + off, sp.t1_ns + off,
                              sp.thread_name))

        obs.tracer.set_observer(observe)
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        from kafkabalancer_tpu_torch import obs

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()
        if obs.tracer._observer is not None:
            obs.tracer.set_observer(self._prev)
        self.spans = [s for s in self.spans
                      if s[2] >= self.t0_ns and s[1] <= self.t1_ns]
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b < self.t0_ns or a > self.t1_ns:
                continue
            self.ops.append((e.name(), a, b, e.metadata_json()))
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy(self) -> List[Interval]:
        return union([(max(a, self.t0_ns), min(b, self.t1_ns))
                      for _, a, b, _ in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def device_ops(self, top: int = 10) -> List[List[Any]]:
        """The ``top`` operation names by total device seconds."""
        tot: Dict[str, float] = {}
        for name, a, b, _ in self.ops:
            k = short_name(name)
            tot[k] = tot.get(k, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List[Any]]:
        """The ``top`` longest stretches of the window with nothing on the
        device, each named by the innermost span of the port open across
        its middle, else by the device operation before it."""
        busy = self.busy()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            out.append([self._name_gap(a, b), (b - a) / 1e9])
        return out

    def _name_gap(self, a: int, b: int) -> str:
        mid = (a + b) // 2
        inner: Optional[Tuple[str, int, int, str]] = None
        for s in self.spans:
            if s[1] <= mid <= s[2] and (inner is None
                                        or s[2] - s[1] < inner[2] - inner[1]):
                inner = s
        if inner is not None:
            return inner[0]
        before = [op for op in self.ops if op[2] <= a]
        if before:
            return "after " + short_name(max(before, key=lambda op: op[2])[0])
        return "before the first device operation"
