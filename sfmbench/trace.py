"""What a traced window gives: device time by kernel, the seconds in
which the device ran anything, and the longest device idle gaps with
what the host was doing in each.

Reads the profiler's own event list (`torch.profiler`, CUPTI on the
card): device events are kernels, copies and sets; host events are the
CUDA calls (launches, copies, synchronisations) the program made. A gap
that no host event covers is the host between such calls, in Python or
in operators' host code.
"""

from __future__ import annotations

import collections

import numpy as np


def _events(prof):
    """(host events, device rows (name, start_ns, end_ns)): the host events
    are left unread until a gap needs them."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns()
            dev.append((e.name(), s, s + e.duration_ns()))
        else:
            host.append(e)
    return host, dev


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> dict:
    """busy_s, kernel_s {name: seconds}, device_ops and idle_gaps (each
    the `top` longest, [name, seconds])."""
    host, dev = _events(prof)
    kernel_ns = collections.Counter()
    for name, s, e in dev:
        kernel_ns[name] += e - s
    merged = _merge([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1],
                    merged[k + 1][0]) for k in range(len(merged) - 1)),
                  reverse=True)[:top]
    idle = []
    if host and gaps:
        hs = np.array([e.start_ns() for e in host], np.int64)
        he = hs + np.array([e.duration_ns() for e in host], np.int64)
        for length, s, e in gaps:
            mid = (s + e) // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = host[inside[np.argmax(hs[inside])]].name() \
                if len(inside) else "(host between CUDA calls)"
            idle.append([name[:200], length * 1e-9])
    kernel_s = {n: t * 1e-9 for n, t in kernel_ns.items()}
    ops = [[n[:200], t * 1e-9] for n, t in kernel_ns.most_common(top)]
    return dict(busy_s=busy, kernel_s=kernel_s, device_ops=ops,
                idle_gaps=idle, events=len(host) + len(dev))
