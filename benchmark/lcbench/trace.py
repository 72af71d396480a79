"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer metrics read.

Host spans come from ``torch.profiler.record_function`` annotations named
``bench.*`` (the harness's calls into the program) and ``phase.*`` (the
program's own phase spans, mirrored into the trace while it runs).  Device
activity is every CUDA kernel, copy and memset the profiler recorded.
Times are in seconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN_PREFIXES = ("bench.", "phase.")


@dataclass
class Trace:
    window: tuple[float, float]
    kernels: list[tuple[str, float, float]] = field(default_factory=list)
    device_ops: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    _busy: list | None = field(default=None, repr=False)
    _ends: list | None = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_seconds(self, *needles: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one of
        the needles."""
        t, n = 0.0, 0
        for name, a, b in self.kernels:
            if any(s in name for s in needles):
                t += b - a
                n += 1
        return t, n

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Merged intervals of the window in which a kernel, copy or memset
        ran."""
        if self._busy is None:
            lo, hi = self.window
            ivs = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device_ops
                         if b > lo and a < hi)
            merged: list[list[float]] = []
            for a, b in ivs:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            self._busy = [(a, b) for a, b in merged]
            self._ends = [b for _, b in self._busy]
        return self._busy

    def busy_s(self, lo: float | None = None, hi: float | None = None) -> float:
        """Seconds of [lo, hi] (the window by default) in which the device ran
        something."""
        busy = self.busy_intervals()
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        t = 0.0
        for a, b in busy[bisect.bisect_left(self._ends, lo):]:
            if a >= hi:
                break
            t += min(b, hi) - max(a, lo)
        return t

    def span_intervals(self, name: str) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == name]

    def idle_share_in(self, name: str) -> float | None:
        """Idle share of the device inside the host spans called `name`."""
        ivs = self.span_intervals(name)
        total = sum(b - a for a, b in ivs)
        if not total:
            return None
        return 1.0 - sum(self.busy_s(a, b) for a, b in ivs) / total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the window summed by the innermost host span at each gap's middle."""
        ops: dict[str, float] = {}
        for name, a, b in self.device_ops:
            ops[name] = ops.get(name, 0.0) + (b - a)
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        gaps: dict[str, float] = {}
        stack: list[tuple[str, float, float]] = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(spans) and spans[i][1] <= mid:
                while stack and stack[-1][2] < spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack else "host.between_calls"
            gaps[label] = gaps.get(label, 0.0) + (b - a)
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]}


class Tracer:
    """Profiles the block it wraps; ``trace`` holds the reduction after."""

    def __init__(self):
        self.trace: Trace | None = None

    @contextlib.contextmanager
    def window(self, sync):
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            with record_function("bench.window"):
                yield
                sync()
        self.trace = reduce_events(_raw_events(prof))


def _raw_events(prof):
    """(name, on the device, start s, end s, annotation) of every event, from
    the profiler's raw results (its event tree is not built: at hundreds of
    thousands of kernels a window that takes minutes)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() / 1e9, e.is_user_annotation())


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, namespaces and parameter
    list (from the first "(" outside its template arguments); copies and
    memsets keep theirs whole."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(junk, "")
    if name.startswith(("Memcpy", "Memset")):
        return name[:limit]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.strip()[:limit]


def reduce_events(events) -> Trace:
    kernels, device_ops, spans = [], [], []
    window = None
    for name, on_device, a, b, annotation in events:
        if on_device:
            if annotation or name.startswith(SPAN_PREFIXES):
                continue
            name = short_name(name)
            device_ops.append((name, a, b))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, a, b))
        elif name == "bench.window":
            window = (a, b)
        elif name.startswith(SPAN_PREFIXES):
            spans.append((name, a, b))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window, kernels, device_ops, spans)
