"""Bounded profiler slices and what the per-layer readers read.

A traced run profiles fixed slices of its work (a number of simulations,
steps or chunks) after its measured window, never the window itself:
recording every host operator of a selfplay move takes minutes, and the
profiler inflates the wall time of what it records.  The harness calls
:meth:`SliceProfiler.tick` at each boundary of a unit of work; a slice
opens at its first unit and closes after its last, with the device
drained at both ends so that its events are its own.  One slice records
device activity alone (its wall time is barely inflated: the device
busy time and the launches come from it); one records host operators
too (the host syncs and the idle gaps by host operator come from it).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch



@dataclass
class SliceData:
    name: str
    units: int
    wall_s: float
    device: list  # (name, start_us, dur_us): kernels, copies and sets on the device
    host: list  # (name, start_us, dur_us, thread): host operators (slices with host=True)


@dataclass
class Plan:
    name: str
    start: int  # first unit (0-based count of ticks)
    units: int
    host: bool


class SliceProfiler:
    """Opens and closes the planned slices as ``tick`` counts units."""

    def __init__(self, plans: list, sync):
        self.plans = sorted(plans, key=lambda p: p.start)
        self.sync = sync
        self.count = 0
        self.active = None
        self.slices: dict = {}

    def tick(self) -> None:
        c = self.count
        self.count += 1
        if self.active is not None and c == self.active[0].start + self.active[0].units:
            self._close()
        for plan in self.plans:
            if plan.start == c and plan.name not in self.slices and self.active is None:
                self._open(plan)

    def finish(self) -> None:
        if self.active is not None:
            self._close()

    def _open(self, plan: Plan) -> None:
        from torch.profiler import ProfilerActivity, profile

        # Off the card (the CPU rehearsal) host operators stand in.
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        if plan.host or not acts:
            acts.append(ProfilerActivity.CPU)
        prof = profile(activities=acts)
        self.sync()
        prof.start()
        self.active = (plan, prof, time.perf_counter())

    def _close(self) -> None:
        plan, prof, t0 = self.active
        self.sync()
        wall = time.perf_counter() - t0
        prof.stop()
        self.active = None
        self.slices[plan.name] = read_events(plan, prof, wall)


def read_events(plan: Plan, prof, wall: float) -> SliceData:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        # A record_function range also appears on the device's timeline as
        # an annotation that spans the work it covers: it is no operation.
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append((e.name, float(start), float(end - start)))
        elif plan.host and e.device_type == DeviceType.CPU:
            host.append((e.name, float(start), float(end - start), e.thread))
    return SliceData(plan.name, plan.units, wall, device, host)


@dataclass
class Trace:
    """What a per-layer reader reads: the slices, the unprofiled window
    (``units``, ``seconds`` and the work it did), the run's counts and the
    shapes of its kernels' calls."""

    cell: str
    cfg: dict
    traffic: dict
    slices: dict = field(default_factory=dict)
    window: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    shapes: dict = field(default_factory=dict)


def busy_us(events) -> float:
    """Microseconds in which at least one device event ran (the union)."""
    spans = sorted((s, s + d) for _, s, d in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def matching(events, patterns) -> list:
    rx = re.compile("|".join(patterns))
    return [e for e in events if rx.search(e[0])]


def is_dtoh(name: str) -> bool:
    return "DtoH" in name or "Device -> Pageable" in name or "Device -> Pinned" in name


NAME_CHARS = 120


def top_device_ops(events, limit: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time
    (names cut to their first ``NAME_CHARS`` characters)."""
    by_name: dict = {}
    for name, _, dur in events:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    return [[name, us / 1e6] for name, us in top]


def idle_gaps(device, host, limit: int = 10) -> list:
    """[[host operator, seconds]]: the device's idle time between its
    events, summed by the innermost host operator running when each gap
    began (on the thread that ran most operators)."""
    if not device or not host:
        return []
    threads: dict = {}
    for h in host:
        threads[h[3]] = threads.get(h[3], 0) + 1
    main = max(threads, key=threads.get)
    ops = sorted((s, s + d, name) for name, s, d, t in host if t == main)
    spans = sorted((s, s + d) for _, s, d in device)
    gaps, end = [], spans[0][1]
    for s, e in spans[1:]:
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    by_op: dict = {}
    stack, i = [], 0
    for at, length in gaps:
        while i < len(ops) and ops[i][0] <= at:
            stack.append(ops[i])
            i += 1
        stack = [o for o in stack if o[1] > at]
        name = stack[-1][2][:NAME_CHARS] if stack else "(no host operator)"
        by_op[name] = by_op.get(name, 0.0) + length
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:limit]
    return [[name, us / 1e6] for name, us in top]


def breakdown(trace: Trace) -> dict | None:
    """The result line's ``breakdown`` from the slice that recorded host
    operators."""
    for sl in trace.slices.values():
        if sl.host:
            return {"device_ops": top_device_ops(sl.device), "idle_gaps": idle_gaps(sl.device, sl.host)}
    return None
