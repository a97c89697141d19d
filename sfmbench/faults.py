"""Faults planted under the timed path, for the test that sees `correct`
come out false and for reading each fault on the card
(`calibrate --fault NAME`). Each is a context manager that patches the
program's module attributes the runners reach and restores them.

verify: `alter_match` (one matched row's column moved, where K1's
answer is produced), `alter_inlier` (one inlier flag of each pair
flipped, where verification's answer is produced), `half_pairs` (half of
a job's pairs left out of matching), `few_hypotheses` (8 RANSAC
hypotheses per model instead of the configuration's), `essential_only`
(the essential-matrix RANSAC alone: F, H and the model selection
skipped).
ba: `unchanged_state` (every LM step returns the state unchanged),
`half_observations` (the odd observations left out of the residuals and
Jacobians), `alter_cost` (the reported cost moved by one part in 1e6).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def alter_match():
    from dagsfm_tpu_torch.ops import matcher_kernel as mk

    def make(orig):
        def fused_match_j(*a, **k):
            j = orig(*a, **k).clone()
            K = j.shape[1]
            for b in range(j.shape[0]):
                rows = torch.nonzero(j[b] >= 0)
                if len(rows):
                    r = int(rows[0, 0])
                    j[b, r] = (j[b, r] + 1) % K
            return j
        return fused_match_j
    return _patched(mk, "fused_match_j", make)


def alter_inlier():
    from dagsfm_tpu_torch.ops import two_view_classify as tvc

    def make(orig):
        def classify_pairs(*a, **k):
            out = orig(*a, **k)
            for pk, res in out.items():
                flags = np.asarray(res.inlier_mask, bool).copy()
                if len(flags):
                    flags[-1] = ~flags[-1]
                out[pk] = res._replace(inlier_mask=flags,
                                       num_inliers=int(flags.sum()))
            return out
        return classify_pairs
    return _patched(tvc, "classify_pairs", make)


def half_pairs():
    from dagsfm_tpu_torch.features import matching as fm

    def make(orig):
        def match_pairs(descriptors, masks, pairs, *a, **k):
            return orig(descriptors, masks, pairs[: len(pairs) // 2], *a,
                        **k)
        return match_pairs
    return _patched(fm, "match_pairs", make)


def _two_view_options(**changes):
    import dataclasses

    from dagsfm_tpu_torch.ops import two_view_classify as tvc

    def make(orig):
        def classify_pairs(pair_data, options=tvc.TwoViewOptions(), *a,
                           **k):
            return orig(pair_data, dataclasses.replace(options, **changes),
                        *a, **k)
        return classify_pairs
    return _patched(tvc, "classify_pairs", make)


def few_hypotheses():
    return _two_view_options(num_hypotheses=8)


def essential_only():
    return _two_view_options(essential_only=True)


def unchanged_state():
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    def make(orig):
        def _apply_step(prob, dcam, dpt, dint=None):
            return prob
        return _apply_step
    return _patched(ba, "_apply_step", make)


def half_observations():
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    def make(orig):
        def _residuals_and_jacobians(prob, refine_int=False):
            out = list(orig(prob, refine_int))
            keep = (torch.arange(out[0].shape[0], device=out[0].device)
                    % 2 == 0).to(out[0].dtype)
            for k, x in enumerate(out):
                if x is not None:
                    out[k] = x * keep.reshape((-1,) + (1,) * (x.dim() - 1))
            return tuple(out)
        return _residuals_and_jacobians
    return _patched(ba, "_residuals_and_jacobians", make)


def alter_cost():
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba

    def make(orig):
        def solve(*a, **k):
            prob, stats = orig(*a, **k)
            return prob, stats._replace(final_cost=stats.final_cost
                                        * (1 + 1e-6))
        return solve
    return _patched(ba, "solve", make)


FAULTS = {"verify": (alter_match, alter_inlier, half_pairs, few_hypotheses,
                     essential_only),
          "ba": (unchanged_state, half_observations, alter_cost)}
