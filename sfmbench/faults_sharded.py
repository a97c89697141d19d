"""Faults planted under the sharded bundle adjustment's timed path, for
reading the check of `ba.final13682x4` under each (`calibrate_sharded`)
and for the test that sees `correct` come out false. Each is a context
manager that patches `parallel/ba_sharded.py`'s module attributes in the
process that enters it; the cell's ranks enter it together on rank 0's
command (`sharded_ranks.FAULT`).

* `cg_reduce_part`: the last rank's part left out of each per-CG reduce
  of the joint solver (the two blocks of S·x), the other reduces as
  they are;
* `drop_shard`: the last shard's observations left out of the local
  problem of the rank that holds it (its points stay);
* `cost_rank0`: the cost reduced to rank 0 only: every rank still
  joins the reduce, but the others keep their own part, decide on it
  and report it.
"""

from __future__ import annotations

from sfmbench.faults import _patched


def cg_reduce_part():
    from dagsfm_tpu_torch.parallel import ba_sharded as bs
    from dagsfm_tpu_torch.parallel import mesh

    def make(orig):
        def all_reduce_many(*xs):
            _, rank, world = mesh.process_group()
            if len(xs) == 2 and rank == world - 1:
                xs = tuple(x * 0 for x in xs)
            return orig(*xs)
        return all_reduce_many
    return _patched(bs, "all_reduce_many", make)


def drop_shard():
    from dagsfm_tpu_torch.parallel import ba_sharded as bs

    def make(orig):
        def _local_problem(prob, shards):
            last = prob.obs_mask.shape[0] - 1
            if last in shards:
                mask = prob.obs_mask.clone()
                mask[last] = False
                prob = prob._replace(obs_mask=mask)
            return orig(prob, shards)
        return _local_problem
    return _patched(bs, "_local_problem", make)


def cost_rank0():
    from dagsfm_tpu_torch.parallel import ba_sharded as bs
    from dagsfm_tpu_torch.parallel import mesh
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    def make(orig):
        def _cost(local, opts):
            own = ba._plain_cost(local, opts._replace(loss="cauchy"))
            total = float(mesh.all_reduce(own.reshape(1).clone())[0])
            return total if mesh.process_group()[1] == 0 else float(own)
        return _cost
    return _patched(bs, "_cost", make)


FAULTS = (cg_reduce_part, drop_shard, cost_rank0)
