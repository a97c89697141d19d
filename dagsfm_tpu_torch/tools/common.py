"""What the ported `tools/` programs share: the device, the card line,
clocks that end in a sync, and the JSON record.

Every tool runs on the card unless the caller asks for another device
(`--device cpu`), prints its record as one JSON object on stdout and
writes it to a file only where `--out PATH` names one. A run on the CPU
labels itself `cpu` and leaves every card metric (a bound at the H100's
bandwidth, a share of its peak) null.
"""

from __future__ import annotations

import contextlib
import json
import socket
import time

import torch

from dagsfm_tpu_torch import device as devmod

# the H100 SXM's published peaks (what a bound is taken against)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores


def resolve(device: str | None) -> torch.device:
    """`cuda` unless the caller names another device; raises without a
    card (device.resolve)."""
    return devmod.resolve("cuda" if device is None else device)


def card(dev: torch.device) -> str:
    """nvidia-smi's `name, power.limit` on the card, "cpu" elsewhere."""
    if dev.type != "cuda":
        return "cpu"
    from dagsfm_tpu_torch.tools.matcher_mfu import card_line
    return card_line()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(seconds: dict, name: str, dev: torch.device):
    """seconds[name] = the host seconds of the block, ended by a sync."""
    sync(dev)
    t0 = time.perf_counter()
    yield
    sync(dev)
    seconds[name] = time.perf_counter() - t0


def call_ms(fn, dev: torch.device, reps: int = 5) -> float:
    """Mean ms per call of `fn` after one warm-up call: device time from
    CUDA events on the card (`matcher_mfu.time_ms`), the host clock on
    the CPU."""
    if dev.type == "cuda":
        from dagsfm_tpu_torch.tools.matcher_mfu import time_ms
        return time_ms(fn, reps)
    return host_ms(fn, dev, reps)[0]


def host_ms(fn, dev: torch.device, reps: int = 1) -> tuple:
    """(mean host ms per call over `reps` calls after a warm-up call,
    ended by a sync; the last call's result)."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3, out


def free_port() -> int:
    """A free TCP port on localhost (for a process group's address)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def peak_gib(dev: torch.device):
    """Peak device memory allocated so far in GiB (None off the card)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def emit(record: dict, out: str | None) -> None:
    """Print the record as JSON on stdout; also write it to `out`."""
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
