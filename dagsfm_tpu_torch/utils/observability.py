"""Observability: stage timers, progress and running info, profiler hook.

Port of dagsfm_tpu/utils/observability.py: a Timer around pipeline
stages, the per-job running info of the distributed workers and the
master's progress table, kept as records in process; `profiler_trace`
wraps `torch.profiler` where the JAX package wraps `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time


@dataclasses.dataclass
class StageTimer:
    """Named stage wall-clock times, summed over repeats."""
    records: dict = dataclasses.field(default_factory=dict)
    _starts: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name] = self.records.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> str:
        lines = ["Elapsed time (s):"]
        for k, v in self.records.items():
            lines.append(f"  {k:>24s}: {v:9.3f}")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(self.records)


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
    around a pipeline stage, written to log_dir as a Chrome trace; None
    is a no-op."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    import os
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
