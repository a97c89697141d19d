"""Profile incremental mapping on a pixel-derived cluster, with every
device-to-host read counted by its caller.

    python -m dagsfm_tpu_torch.tools.mapper_profile [--n 105] [--out PATH]
        [--device cuda|cpu]

Counterpart of tools/mapper_profile.py: e2e_1000's scene and pipeline at
n images (rendered ring sector -> SIFT -> sequential pairs with loop
closure -> K1 matching -> full E/F/H verification), then
`IncrementalMapper.reconstruct` (seed 0, initial triangulation angle 2
degrees) twice: once plain, timed with the host clock ended by a sync,
and once under cProfile with the reads counted. The record holds the
pipeline's stage seconds, the plain mapping's seconds and images/s, the
top 30 functions by cumulative time and the top 20 by own time, and the
reads.

cProfile sees torch's reads as builtins (`{method 'item' of
'torch._C.TensorBase' objects}`) and `bool()`, `float()` and `int()` of
a tensor not at all, so for the profiled run `Tensor.item`, `.tolist`,
`.cpu`, `.numpy`, `__bool__`, `__float__`, `__int__`, `__index__` and
`torch.cuda.synchronize` are wrapped: each call on a tensor on the run's
device is counted under the first caller outside torch (file:line
function). On the card that is every device-to-host read the mapper
makes; on the CPU it counts the same calls on host tensors. The record
gives the reads in all, per registered image, by kind and by caller.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import io
import os
import pstats
import sys

import torch

from dagsfm_tpu_torch.tools import common

READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
         "__int__", "__index__")
_TORCH_DIR = os.path.dirname(torch.__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _caller() -> str:
    """file:line function of the first frame outside torch and this
    module."""
    f = sys._getframe(2)
    while f is not None and (f.f_code.co_filename.startswith(_TORCH_DIR)
                             or f.f_code.co_filename == __file__):
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename
    if path.startswith(_ROOT):
        path = os.path.relpath(path, _ROOT)
    return f"{path}:{f.f_lineno} {f.f_code.co_name}"


@contextlib.contextmanager
def counting_reads(dev: torch.device):
    """Counter of (kind, caller) -> calls for the block (see the module
    docstring)."""
    counts = collections.Counter()
    saved = {}

    def wrap(kind, orig):
        def read(self, *a, **k):
            if self.device.type == dev.type:
                counts[(kind, _caller())] += 1
            return orig(self, *a, **k)
        return read

    for kind in READS:
        saved[kind] = torch.Tensor.__dict__.get(kind)
        setattr(torch.Tensor, kind, wrap(kind, getattr(torch.Tensor, kind)))
    sync = torch.cuda.synchronize

    def counted_sync(*a, **k):
        counts[("synchronize", _caller())] += 1
        return sync(*a, **k)

    if dev.type == "cuda":
        torch.cuda.synchronize = counted_sync
    try:
        yield counts
    finally:
        torch.cuda.synchronize = sync
        for kind, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, kind)
            else:
                setattr(torch.Tensor, kind, orig)


def _top(stats: pstats.Stats, key: str, n: int) -> list:
    stats.sort_stats(key)
    out = []
    for fn in stats.fcn_list[:n]:
        cc, nc, tt, ct, _ = stats.stats[fn]
        path, line, name = fn
        if path.startswith(_ROOT):
            path = os.path.relpath(path, _ROOT)
        out.append({"function": f"{path}:{line}({name})", "calls": nc,
                    "own_s": tt, "cumulative_s": ct})
    return out


def run(n: int = 105, device=None, log=sys.stderr) -> dict:
    """The profile at n images on `device` (the card unless told);
    returns the record."""
    from dagsfm_tpu_torch.sfm.incremental_mapper import IncrementalMapper
    from dagsfm_tpu_torch.tools import e2e_1000

    dev = common.resolve(device)
    pipe_secs = {}
    _, fp, _, dm_opts = e2e_1000.pipeline(n, dev, pipe_secs)
    print(f"pipeline seconds: {pipe_secs}", file=log, flush=True)
    cams2, imgs2, graph = fp.to_mapper_inputs()

    def mapper():
        return IncrementalMapper(cams2, imgs2, graph, dm_opts.mapper,
                                 device=dev)

    secs = {}
    with common.stage(secs, "plain", dev):
        rec = mapper().reconstruct()
    reg = rec.num_reg_images()
    print(f"mapper: {reg}/{n} registered in {secs['plain']:.3f} s "
          f"({reg / secs['plain']:.3f} images/s)", file=log, flush=True)

    pr = cProfile.Profile()
    with common.stage(secs, "profiled", dev), counting_reads(dev) as counts:
        pr.enable()
        rec2 = mapper().reconstruct()
        pr.disable()
    if rec2.num_reg_images() != reg:
        raise AssertionError("the profiled mapping registered "
                             f"{rec2.num_reg_images()} images, the plain "
                             f"one {reg}")
    text = io.StringIO()
    stats = pstats.Stats(pr, stream=text)
    stats.sort_stats("cumulative").print_stats(30)
    stats.sort_stats("tottime").print_stats(20)
    print(text.getvalue(), file=log, flush=True)

    total = sum(counts.values())
    by_kind = collections.Counter()
    for (kind, _), c in counts.items():
        by_kind[kind] += c
    callers = [{"kind": kind, "caller": where, "count": c,
                "per_registered_image": c / max(reg, 1)}
               for (kind, where), c in counts.most_common(30)]
    print("device-to-host reads by caller (top 30):", file=log)
    for c in callers:
        print(f"  {c['count']:8d}  {c['kind']:12s} {c['caller']}", file=log)
    return {"what": f"incremental mapping of {n} rendered images under "
                    f"cProfile on {dev.type} "
                    "(dagsfm_tpu_torch/tools/mapper_profile.py)",
            "num_images": n, "registered": reg,
            "pipeline_seconds": pipe_secs,
            "mapping_seconds": secs["plain"],
            "images_per_s": reg / secs["plain"],
            "profiled_seconds": secs["profiled"],
            "reads": {"total": total,
                      "per_registered_image": total / max(reg, 1),
                      "by_kind": dict(by_kind), "top_callers": callers},
            "cprofile": {"by_cumulative": _top(stats, "cumulative", 30),
                         "by_own_time": _top(stats, "tottime", 20)},
            "device": dev.type, "card": common.card(dev)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=105)
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    common.emit(run(args.n, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
