"""The benchmark's harness: finds a cell's configuration, traffic mix,
runner and metric readers by the names in BENCHMARK.json, runs set-up,
the measured window and the check, and builds the result line.

Layout under the benchmark's folder (all found by name, so a new cell,
configuration or metric is new files and entries, never an edit):

* `configs/<config>.json`: the configuration as it is run;
* `traffic/<traffic>.json`: the mix's parameters, its `runner` and the
  limits of its check;
* `runners/<runner>.py`: `setup(cfg, mix, seed, device)`, `warmup`,
  `reset`, `unit` (one unit of work, finished and synchronised; returns
  its work), `e2e(state, seconds)`, `counters`, `release` and
  `check(state, seed)` -> ([(name, value, limit)], failed); optionally
  `cycle(state)`, the units of one pass over a pool of work: a window
  then ends only on a whole pass, so that every run does the same work;
* `metrics/<metric>.py`: `read(ctx)` -> a number, or None where the cell
  has nothing to read. ctx holds `counters` (the runner's, over the
  window's untraced units) and `window_s` (their seconds), and on the
  card `trace`: trace.summarize's reading of the window's first unit,
  traced, with its `window_s` and the runner's `counters` over it. In a
  `--trace 1` run the units after the traced one run untraced for
  `--seconds`, so that times on the host's clock are read without the
  profiler's own cost.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from sfmbench import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "dagsfm_tpu")
TRAFFIC_SUFFIXES = (".json",)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (names may hold dots)."""
    name = "sfmbench_file_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    return sorted(m for m, v in list(sys.modules.items())
                  if v is not None and m.split(".")[0] in FORBIDDEN)


def deep_update(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One entry of `workloads`, with everything found by its names."""

    def __init__(self, root: Path, name: str, overrides: dict | None = None):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        bench = self.root / self.spec["paths"][0]
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = w = cells[name]
        self.name = name
        cfg = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        self.config = load_json(self.root / cfg["file"])
        self.mix = load_json(next(
            p for p in (bench / "traffic" / f"{w['traffic']}{s}"
                        for s in TRAFFIC_SUFFIXES) if p.exists()))
        over = overrides or {}
        self.config = deep_update(self.config, over.get("config", {}))
        self.mix = deep_update(self.mix, over.get("traffic", {}))
        self.runner = load_module(bench / "runners" /
                                  f"{self.mix['runner']}.py")
        self.e2e = [m for m in self.spec["end_to_end"]
                    if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
        self.readers = {m["name"]: load_module(bench / "metrics" /
                                               f"{m['name']}.py")
                        for m in self.per_layer}


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(cell, st, seconds, dev, after_first=None):
    """(work, the work and seconds of each unit, elapsed seconds): units
    until `seconds` have passed and a whole number of the runner's
    cycles is done; the unit in progress at the close is finished and
    counted. after_first(), where given, runs once the first unit has
    finished (a traced run stops its profiler there), and the `seconds`
    are counted from its return: the untraced units that follow make a
    window of their own."""
    cycle = cell.runner.cycle(st) if hasattr(cell.runner, "cycle") else 1
    units = []
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        w = cell.runner.unit(st)
        units.append((w, time.perf_counter() - t))
        if after_first is not None and len(units) == 1:
            after_first()
            t0 = time.perf_counter()
            continue
        if time.perf_counter() - t0 >= seconds and len(units) % cycle == 0:
            break
    _sync(dev)
    return sum(w for w, _ in units), units, time.perf_counter() - t0


def _minus(after: dict, before: dict) -> dict:
    return {k: (v - before[k] if isinstance(v, (int, float)) and
                not isinstance(v, bool) and k in before else v)
            for k, v in after.items()}


def device_record(dev, chips: int) -> dict:
    import torch
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, err=None, before_release=None) -> dict | None:
    """One run: set-up, warm-up, the window and the check. Returns the
    result line's object, or None when a forbidden module was loaded.
    before_release(state), where given, runs once the metrics are read
    and before the program's state is freed (the calibration's control
    runs there)."""
    import torch
    err = err or sys.stderr
    t0 = time.perf_counter()
    st = cell.runner.setup(cell.config, cell.mix, seed, dev)
    _sync(dev)
    t1 = time.perf_counter()
    cell.runner.warmup(st)
    cell.runner.reset(st)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    print(f"setup: start to set-up {t0 - t_start:.3f} s, inputs and "
          f"program state {t1 - t0:.3f} s, warm-up "
          f"{t_start + setup_s - t1:.3f} s", file=err)
    summary, traced = None, {}
    if trace:
        # the first unit of the window is traced: a unit of verification
        # launches about three million kernels and CUDA calls, and the
        # profiler takes about as long again to hand them over. On the
        # card, the device's activity alone (kernels, copies and the CUDA
        # calls that launched them). The units after it run untraced.
        acts = [torch.profiler.ProfilerActivity.CUDA
                if dev.type == "cuda" else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)

        def stop():
            _sync(dev)
            traced["window_s"] = time.perf_counter() - t_trace
            traced["counters"] = dict(cell.runner.counters(st))
            prof.stop()
            print(f"trace: profiler stopped in "
                  f"{time.perf_counter() - t_trace - traced['window_s']:.3f}"
                  " s", file=err)

        _sync(dev)
        prof.start()
        t_trace = time.perf_counter()
        work, units, elapsed = _window(cell, st, seconds, dev, stop)
    else:
        work, units, elapsed = _window(cell, st, seconds, dev)
    device = device_record(dev, cell.entry["chips"])
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=err)
        return None
    units_of = {m["name"]: m["unit"] for m in cell.spec["end_to_end"]}
    units_of.update({m["name"]: m["unit"] for m in cell.spec["per_layer"]})
    if trace:
        if dev.type == "cuda":
            t_read = time.perf_counter()
            summary = dict(trace_mod.summarize(prof), **traced)
            print(f"trace: {summary['events']} events read in "
                  f"{time.perf_counter() - t_read:.3f} s", file=err)
            device.update(busy_s=summary["busy_s"],
                          window_s=summary["window_s"])
        del prof
        ctx = dict(counters=_minus(cell.runner.counters(st),
                                   traced["counters"]),
                   window_s=elapsed,
                   trace=summary, cell=cell.name)
        values = {n: r.read(ctx) for n, r in cell.readers.items()}
    else:
        values = dict(cell.runner.e2e(st, elapsed), setup_s=setup_s)
    metrics = {n: {"value": float(v), "unit": units_of[n]}
               for n, v in values.items() if v is not None}
    if before_release is not None:
        before_release(st)
    cell.runner.release(st)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = cell.runner.check(st, seed)
    if forbidden_modules():
        print("forbidden modules loaded by the check", file=err)
        return None
    correct = all(v <= lim for _, v, lim in checks)
    if getattr(st, "parts", None) is not None:
        print(f"parts: {json.dumps(st.parts)}", file=err)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=err)
    out = dict(correct=bool(correct), attempted=int(work), failed=int(failed),
               metrics=metrics, device=device)
    if summary is not None:
        out["breakdown"] = dict(device_ops=summary["device_ops"],
                                idle_gaps=summary["idle_gaps"])
    out["unit_seconds"] = [u for _, u in units]
    out["checks"] = {n: {"value": float(v), "limit": float(lim)}
                     for n, v, lim in checks}
    return out
