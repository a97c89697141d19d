"""Observability: the program's spans and counted host reads, progress and
running info, profiler hook.

Port of dagsfm_tpu/utils/observability.py, whose StageTimer grew here
into one recorder of nested spans (`StageTimer` stays, its stages spans):

* `span(name)`: a `with` block whose host seconds (`perf_counter_ns`)
  and call count add to its name's entry in the record of the outermost
  open span (its root); nothing syncs the card.
* `host_read(x, cast)`: every explicit device-to-host read of the hot
  paths (`x.cpu()`, or `float`, `int`, `bool` of a tensor) goes through
  it; it adds a read and the seconds it blocked (`wait_s`) to the
  innermost open span. The value is exactly what the read gives.
* `count(name, n)`: a counter of the open root.
* When a root ends, its record (each span's `seconds`, `wait_s`, `reads`
  and `calls`, the root's counters) joins a deque of the last
  `MAX_ROOTS` roots (`roots()`). A root during which a
  `torch.profiler` session was active is `profiled`: each of its spans
  is then also a `record_function` range, and the record keeps each
  span's start and end (`stamps`) on the profiler's clock, the epoch
  nanoseconds of `time.time_ns()` that `KinetoEvent.start_ns()` reads.
  A profiler that collects no CPU activity registers no
  `record_function` callbacks, so the ranges then record nothing and a
  trace of the card alone holds no annotation of a span; the stamps and
  the flag are kept all the same.

Recording is on by default; `enable(False)` turns it off (a span then
still times itself for its caller and records nothing). Open spans are
per thread; finished roots are shared.

`RunningInfo` and `ProgressMonitor` keep the distributed workers' and
the master's telemetry; `profiler_trace` wraps `torch.profiler` where
the JAX package wraps `jax.profiler`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch

MAX_ROOTS = 512          # a window of a few hundred jobs or solves

_on = True
_local = threading.local()
_roots: collections.deque = collections.deque(maxlen=MAX_ROOTS)
_roots_lock = threading.Lock()
_profiling = torch._C._autograd._profiler_enabled


def enable(on: bool = True) -> None:
    """Turn recording on or off for the whole process."""
    global _on
    _on = bool(on)


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class _Root:
    __slots__ = ("entries", "counters", "profiled", "stamps")

    def __init__(self):
        self.entries = {}       # name -> [ns, wait ns, reads, calls]
        self.counters = {}
        self.profiled = False
        self.stamps = []

    def record(self, name: str) -> dict:
        return dict(
            name=name,
            spans={k: dict(seconds=e[0] / 1e9, wait_s=e[1] / 1e9,
                           reads=e[2], calls=e[3])
                   for k, e in self.entries.items()},
            counters=dict(self.counters), profiled=self.profiled,
            stamps=self.stamps)


class span:
    """`with span("verify.ransac.E") as s:`; `s.seconds` once it ends."""

    __slots__ = ("name", "seconds", "_t0", "_entry", "_root", "_range",
                 "_s0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._root = None
        if _on:
            stack = _open()
            root = stack[-1]._root if stack else _Root()
            entry = root.entries.get(self.name)
            if entry is None:
                entry = root.entries[self.name] = [0, 0, 0, 0]
            self._entry, self._root, self._range = entry, root, None
            stack.append(self)
            if _profiling():
                root.profiled = True
                self._range = torch.autograd.profiler.record_function(
                    self.name).__enter__()
                self._s0 = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self.seconds = dt / 1e9
        root = self._root
        if root is None:
            return False
        self._entry[0] += dt
        self._entry[3] += 1
        if self._range is not None:
            root.stamps.append((self.name, self._s0, time.time_ns()))
            self._range.__exit__(None, None, None)
        elif _profiling():
            root.profiled = True
        stack = _open()
        stack.pop()
        if not stack:
            rec = root.record(self.name)
            with _roots_lock:
                _roots.append(rec)
        return False


def host_read(x, cast=None):
    """`x.cpu()`, or `cast(x)` for cast in (float, int, bool), counted
    and timed on the innermost open span."""
    if not _on or not _open():
        return x.cpu() if cast is None else cast(x)
    t0 = time.perf_counter_ns()
    out = x.cpu() if cast is None else cast(x)
    entry = _local.open[-1]._entry
    entry[1] += time.perf_counter_ns() - t0
    entry[2] += 1
    return out


def count(name: str, n: int = 1) -> None:
    """Add n to the open root's counter `name` (nothing without a root)."""
    if _on:
        stack = _open()
        if stack:
            c = stack[-1]._root.counters
            c[name] = c.get(name, 0) + n


def roots() -> list:
    """The finished root records, oldest first."""
    with _roots_lock:
        return list(_roots)


def clear() -> None:
    with _roots_lock:
        _roots.clear()


@dataclasses.dataclass
class StageTimer:
    """Named stage seconds summed over repeats; each stage is a span."""
    records: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        s = span(name)
        try:
            with s:
                yield
        finally:
            self.records[name] = self.records.get(name, 0.0) + s.seconds

    def report(self) -> str:
        lines = ["Elapsed time (s):"]
        for k, v in self.records.items():
            lines.append(f"  {k:>24s}: {v:9.3f}")
        return "\n".join(lines)


@dataclasses.dataclass
class RunningInfo:
    """One cluster job's telemetry (SfMRunningInfo)."""
    idle: bool = True
    in_progress: bool = False
    completed: bool = False
    running_time_s: float = 0.0
    total_image_num: int = 0
    registered_image_num: int = 0
    total_matching_pairs: int = 0
    matched_image_pairs: int = 0

    def reset(self) -> None:
        self.__init__()


class ProgressMonitor:
    """In-process table over parallel cluster jobs (ShowProgress): one
    RunningInfo per job; `render()` returns the table."""

    def __init__(self):
        self.jobs: dict[int, RunningInfo] = {}
        self._t0 = time.perf_counter()

    def job(self, job_id: int) -> RunningInfo:
        return self.jobs.setdefault(job_id, RunningInfo())

    def start(self, job_id: int, total_images: int) -> None:
        info = self.job(job_id)
        info.idle = False
        info.in_progress = True
        info.total_image_num = total_images

    def update(self, job_id: int, registered: int) -> None:
        self.job(job_id).registered_image_num = registered

    def complete(self, job_id: int) -> None:
        info = self.job(job_id)
        info.in_progress = False
        info.completed = True
        info.running_time_s = time.perf_counter() - self._t0

    def all_completed(self) -> bool:
        return all(j.completed for j in self.jobs.values()) \
            and bool(self.jobs)

    def render(self) -> str:
        rows = [f"{'job':>4} {'status':>12} {'progress':>12} {'time':>8}"]
        for jid, j in sorted(self.jobs.items()):
            status = ("done" if j.completed
                      else "running" if j.in_progress else "idle")
            prog = f"{j.registered_image_num}/{j.total_image_num}"
            rows.append(f"{jid:>4} {status:>12} {prog:>12} "
                        f"{j.running_time_s:8.1f}")
        return "\n".join(rows)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """A `torch.profiler` trace (CPU and, where present, CUDA activity)
    around a pipeline stage, written to log_dir as a Chrome trace that
    shows the program's spans above the kernels they launched; yields
    the profiler (None, and no trace, when log_dir is None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    import os
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
