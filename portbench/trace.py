#
# The traced window: torch.profiler over the window, reduced to what the
# per-layer readers take.
#
# Device busy time is the union of the intervals of every kernel, copy and
# memset on the card inside the window (chip_smoke.py's profile_once,
# frozen here).  The trace is complete when it holds one event for each
# launch that the port's kernel wrappers counted in the window (a trace of
# the kNN path once lost one of two 0.7-s kernels); a reader of an
# incomplete trace gives nothing.  Idle gaps are named by the innermost
# host range open when the gap began: one of the port's record_function
# ranges (core.ingest, knn.dispatch, ...) or the harness's own
# (portbench.call around each call, portbench.window around the loop).
#

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW_RANGE = "portbench.window"
CALL_RANGE = "portbench.call"

# the port's kernels as a trace names them (each in an anonymous namespace)
PORT_KERNEL_SYMBOLS = ("min_dist_argmin_kernel", "min_dist_tile_kernel", "bin_features_fm_kernel", "hist_kernel",
                       "hist_mma_kernel", "knn_topm_tile_kernel", "knn_count_tile_kernel", "radix_merge_kernel",
                       "window_merge_kernel", "probed_lut_kernel", "fastscan_probed_kernel", "ring_shift_kernel")
# launched beside hist_mma_kernel by the same wrapper call: not counted
PORT_AUX_SYMBOLS = ("hist_mask_stats_kernel", "hist_split_sum_kernel")

# the port's kernel wrappers (module, function), each counting its launches
# in `.launches`
KERNEL_WRAPPERS = (
    ("nearest_center", "min_dist_argmin"),
    ("binning", "bin_features_fm"),
    ("forest_hist", "node_histograms_mma"),
    ("forest_hist", "node_histograms_atomic"),
    ("forest_hist", "node_histograms_bucketed"),
    ("knn_kernels", "knn_candidates"),
    ("knn_kernels", "knn_candidates_audit"),
    ("knn_kernels", "knn_fused_merge"),
    ("knn_kernels", "knn_count"),
    ("pq_kernels", "lut_accumulate"),
    ("pq_kernels", "lut_accumulate_probed"),
    ("pq_kernels", "fastscan_lut_accumulate"),
    ("pq_kernels", "fastscan_lut_accumulate_probed"),
    ("exchange_kernels", "ring_shift"),
)


def launches() -> Dict[str, int]:
    """Launches each of the port's kernel wrappers has counted so far."""
    import importlib

    out = {}
    for module, fn in KERNEL_WRAPPERS:
        mod = importlib.import_module(f"spark_rapids_ml_tpu_torch.ops.{module}")
        out[fn] = int(getattr(mod, fn).launches)
    return out


def port_kernel(name: str) -> Optional[str]:
    """The port's kernel symbol a trace event names, or None."""
    if "at::" in name:
        return None
    return next((s for s in PORT_KERNEL_SYMBOLS + PORT_AUX_SYMBOLS if f"(anonymous namespace)::{s}" in name), None)


@dataclass
class Trace:
    """A traced window, in the profiler's microseconds."""

    window: Tuple[float, float]                      # the window range's start, end
    device: List[Tuple[str, float, float]]           # kernels, copies, memsets
    host: List[Tuple[str, float, float]]             # record_function ranges
    launches_counted: int = 0                        # by the port's wrappers
    port_events: Dict[str, List[float]] = field(default_factory=dict)  # symbol -> durations (us)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def traced_launches(self) -> int:
        return sum(len(v) for s, v in self.port_events.items() if s not in PORT_AUX_SYMBOLS)

    @property
    def complete(self) -> bool:
        return self.traced_launches == self.launches_counted

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        merged: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def range_us(self, name: str) -> List[float]:
        """Durations of the host range `name` inside the window."""
        lo, hi = self.window
        return [e - s for n, s, e in self.host if n == name and s >= lo and e <= hi]

    def device_ops(self, top: int = 10) -> List[List]:
        """[name, seconds] of the device operations that took the most."""
        per: Dict[str, float] = {}
        lo, hi = self.window
        for n, s, e in self.device:
            if s >= lo and e <= hi:
                per[n] = per.get(n, 0.0) + (e - s)
        ranked = sorted(per.items(), key=lambda kv: kv[1], reverse=True)[:top]
        return [[n, us / 1e6] for n, us in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[host range, seconds]: the device's idle time in the window, by
        the innermost host range open when each gap began."""
        lo, hi = self.window
        edges, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                edges.append((at, s))
            at = max(at, e)
        if hi > at:
            edges.append((at, hi))
        ranges = sorted(self.host, key=lambda t: t[1])
        per: Dict[str, float] = {}
        for g0, g1 in edges:
            name, start = "host", float("-inf")
            for n, s, e in ranges:
                if s > g0:
                    break
                if e > g0 and s >= start:
                    name, start = n, s
            per[name] = per.get(name, 0.0) + (g1 - g0)
        ranked = sorted(per.items(), key=lambda kv: kv[1], reverse=True)[:top]
        return [[n, us / 1e6] for n, us in ranked]


@contextlib.contextmanager
def profiled(on_cuda: bool) -> Iterator[list]:
    """torch.profiler around the block; yields a list that holds the
    profiler once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    holder: list = []
    with profile(activities=activities, acc_events=True) as prof:
        yield holder
    holder.append(prof)


def reduce(prof, launches_counted: int) -> Trace:
    """The profiler's events as a Trace."""
    from torch.autograd import DeviceType

    events = prof.events()
    host, device_raw = [], []
    annotations = set()
    window = None
    port_events: Dict[str, List[float]] = {}
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if getattr(e, "is_user_annotation", False) or e.name.startswith(("portbench.", "core.", "knn.")):
                annotations.add(e.name)
                host.append((e.name, s, t))
                if e.name == WINDOW_RANGE:
                    window = (s, t)
        elif not e.name.startswith("Activity Buffer"):
            device_raw.append((e.name, s, t))
    # a range's device-side annotation carries the range's name: not work
    device = [d for d in device_raw if d[0] not in annotations]
    for n, s, t in device:
        symbol = port_kernel(n)
        if symbol is not None:
            port_events.setdefault(symbol, []).append(t - s)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_RANGE} range")
    return Trace(window=window, device=device, host=host, launches_counted=launches_counted,
                 port_events=port_events)
