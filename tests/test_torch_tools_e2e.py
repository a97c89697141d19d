"""The port's e2e_1000 and mapper_profile on the CPU at a small n.

e2e_1000 runs the reference tool's scene and options (rendered ring ->
SIFT -> sequential pairs with loop closure -> full E/F/H -> distributed
mapper through the lease worker -> merge -> retriangulation -> final BA)
and holds its own gates (at least 90 % registered, ATE < 0.15), with the
partitions checkpointed under a work directory from which a second
lease worker resumes without mapping; `main` writes its record only to
--out. mapper_profile, from the same pipeline (run once for the
module), registers at least 90 % and lists the callers of its
device-to-host reads. The slow twin runs the JAX package's
tools/e2e_1000.py as a process at the same n, in a temporary directory
with --work and --out there: both records pass the gates and the
port's has every key of the reference's. The repo's records of the JAX
tools stay byte for byte."""
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from dagsfm_tpu_torch.tools import e2e_1000, mapper_profile

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 20                   # the fewest ring images that map whole here
RECORDS = {
    "E2E_r05.json":
        "c330d48553e49ff2e93d74788866b4929caa39a3d1f774a15bb8536cd0588ceb",
    "BA_PHASES_r05.json":
        "77eb49fe8c751e5fdd55ddca3d218a42158f4acc23d3f3b7e94e1f441ea9c387",
    "SCALING_r05.json":
        "52114dea7b63d8a74e37421211f8dad49947d496fcdb07d79ed465a62e1cb391",
    "MULTIPROC_r04.json":
        "153a9e21c650a55533dfbbbd6c05934740696081efb4c15751d135b0d1bfdb1b",
}


class _Log:
    def __init__(self):
        self.lines = []

    def write(self, text):
        self.lines.append(text)

    def flush(self):
        pass


def _gates(rec):
    assert rec["registered"] >= 0.9 * rec["num_images"], rec
    assert rec["ate"] < 0.15, rec


@pytest.fixture(scope="module")
def shared_pipeline():
    """`e2e_1000.pipeline` (render, SIFT, pairs, matching, verification)
    run once for the module and handed again to e2e_1000 and
    mapper_profile, which both start from it."""
    real, cache = e2e_1000.pipeline, {}

    def once(n, dev, secs):
        if n not in cache:
            first = {}
            cache[n] = (real(n, dev, first), first)
        out, first = cache[n]
        secs.update(first)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e_1000, "pipeline", once)
        yield


@pytest.fixture(scope="module")
def port_record(tmp_path_factory, shared_pipeline):
    work = str(tmp_path_factory.mktemp("e2e_work"))
    return e2e_1000.run(N, work=work, device="cpu", log=_Log()), work


def test_e2e_1000_holds_its_gates_on_the_cpu(port_record):
    rec, work = port_record
    _gates(rec)
    assert rec["num_clusters"] == len(rec["clustering"]["sizes"]) >= 1
    assert rec["clustering"]["cut"] == "SPECTRAL"
    assert rec["card"] == "cpu" and rec["peak_device_memory_gib"] is None
    assert rec["k1_launches"] == 0            # the plain matcher on the CPU
    assert {"render", "extraction", "pair_selection", "matching",
            "verification", "view_graph", "rotation_averaging",
            "clustering", "cluster_sfm_lease_workers", "merge",
            "retriangulate", "final_ba", "total"} <= set(rec["stage_seconds"])
    assert os.path.exists(os.path.join(work, "partition0", "cameras.bin"))
    assert os.path.exists(os.path.join(work, "clusters.json"))


def test_e2e_1000_resumes_from_its_partitions(port_record):
    """A second lease worker on the run's work directory finds every
    cluster mapped and maps none again (the run's resume path)."""
    from dagsfm_tpu_torch.parallel.distributed import run_worker
    rec, work = port_record
    with open(os.path.join(work, "clusters.json")) as f:
        jobs = json.load(f)
    assert len(jobs) == rec["num_clusters"]
    assert sorted(rec["clusters_mapped_here"]) == list(range(len(jobs)))
    assert run_worker({}, {}, None, jobs, work, host_id=1,
                      device="cpu") == []


def test_e2e_1000_main_writes_only_where_told(monkeypatch, tmp_path,
                                              capsys):
    record = {"registered": 3, "ate": 0.01}
    seen = []
    monkeypatch.setattr(e2e_1000, "run",
                        lambda *a: seen.append(a) or record)
    monkeypatch.chdir(tmp_path)
    assert e2e_1000.main(["--n", "7", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == []             # nothing without --out
    assert e2e_1000.main(["--n", "7", "--device", "cpu", "--work", "w",
                          "--out", "e2e.json"]) == 0
    assert seen == [(7, None, "cpu"), (7, "w", "cpu")]
    with open(tmp_path / "e2e.json") as f:
        assert json.load(f) == record
    assert os.listdir(tmp_path) == ["e2e.json"]
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed] == [record, record]


def test_mapper_profile_lists_the_read_callers(shared_pipeline):
    log = _Log()
    rec = mapper_profile.run(N, device="cpu", log=log)
    assert rec["registered"] >= 0.9 * N
    reads = rec["reads"]
    assert reads["total"] == sum(reads["by_kind"].values()) > 0
    assert reads["per_registered_image"] == reads["total"] / rec["registered"]
    assert reads["top_callers"] and all(
        c["caller"].startswith("dagsfm_tpu_torch/")
        for c in reads["top_callers"])
    assert len(rec["cprofile"]["by_cumulative"]) == 30
    assert len(rec["cprofile"]["by_own_time"]) == 20
    assert any("device-to-host reads by caller" in line for line in log.lines)
    # the wrappers are gone again
    assert "item" not in torch.Tensor.__dict__
    assert "__bool__" not in torch.Tensor.__dict__


@pytest.mark.slow
def test_the_reference_tool_at_the_same_n(tmp_path, port_record):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DAGSFM_COMPILE_CACHE="off")
    out = tmp_path / "reference.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "e2e_1000.py"),
         "--n", str(N), "--work", str(tmp_path / "work"), "--out",
         str(out)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        ref = json.load(f)
    rec, _ = port_record
    _gates(ref)
    _gates(rec)
    assert set(ref) <= set(rec)
    assert set(ref["stage_seconds"]) <= set(rec["stage_seconds"])


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_the_reference_tools_records_are_unchanged(name):
    with open(os.path.join(ROOT, name), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == RECORDS[name]
