"""Image-pair selection: BoW retrieval, sequential pairs with loop
detection, spatial, transitive and listed pairs.

Port of dagsfm_tpu/features/retrieval.py. The device math is Lloyd
k-means (`kmeans_fit`) and the BoW histograms (`bow_histograms`), both
on the descriptors' device; TF-IDF weighting, ranking, deduplication and
the pair loops stay in numpy in the reference's call order, so equal
histograms give equal pair lists.

k-means' initial centroids are the one draw torch cannot replay
(`jax.random.choice(key, N, (k,), replace=False)`): they come from a
`torch.Generator` through `_draw_init`, which tests replace with the
reference's draws. Every numpy `default_rng(seed)` draw stays a numpy
draw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod

# (B, K, k) distance elements per bow_histograms chunk (256 MiB in f32)
_CHUNK_ELEMS = 1 << 26


class RetrievalOptions(NamedTuple):
    vocab_size: int = 256
    kmeans_iters: int = 20
    num_neighbors: int = 50
    sample_per_image: int = 256   # descriptors sampled for vocab training


def _draw_init(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct row indices of n, drawn from `generator`."""
    return torch.randperm(n, generator=generator)[:k]


def generator(seed: int) -> torch.Generator:
    """The CPU generator k-means draws its initial centroids from."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


def kmeans_fit(data: torch.Tensor, gen: torch.Generator, k: int,
               iters: int = 20) -> torch.Tensor:
    """Lloyd k-means on (N, D) -> (k, D) centroids, on data's device.

    Distances are the reference's -2 x.c + |c|^2; the argmin takes the
    first index on ties; new centroids are a one-hot product (no
    atomics), an empty cluster keeps its centroid."""
    idx = _draw_init(data.shape[0], k, gen).to(data.device)
    cents = data[idx]
    for _ in range(iters):
        d2 = -2.0 * data @ cents.T + torch.sum(cents ** 2, -1)[None, :]
        assign = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(data.dtype)
        counts = onehot.sum(0)
        newc = (onehot.T @ data) / torch.clamp(counts, min=1e-9)[:, None]
        cents = torch.where((counts > 0)[:, None], newc, cents)
    return cents


def bow_histograms(desc: torch.Tensor, mask: torch.Tensor,
                   cents: torch.Tensor, k: int) -> torch.Tensor:
    """(B, K, D) descriptors -> (B, k) term-frequency histograms of the
    masked-in slots. Images go in chunks so the (B, K, k) distance array
    stays under _CHUNK_ELEMS elements; each image's row is the same."""
    B, K, _ = desc.shape
    c2 = torch.sum(cents ** 2, -1)
    step = max(1, _CHUNK_ELEMS // max(K * k, 1))
    out = []
    for s in range(0, B, step):
        d2 = -2.0 * torch.einsum("bkd,vd->bkv", desc[s:s + step], cents) \
            + c2[None, None, :]
        assign = torch.argmin(d2, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, k).to(desc.dtype)
        out.append((onehot * mask[s:s + step, :, None]).sum(1))
    return torch.cat(out)


def bow_similarity_matrix(descriptors: dict, masks: dict,
                          opts: RetrievalOptions = RetrievalOptions(),
                          seed: int = 0, device=None):
    """(ids, sim): the tf-idf BoW cosine similarity of every image pair,
    the diagonal -1. One vocabulary fit, one similarity product."""
    dev = devmod.resolve(device)
    ids = sorted(descriptors)
    if len(ids) < 2:
        return ids, np.zeros((len(ids), len(ids)))
    rng = np.random.default_rng(seed)
    samples = []
    for i in ids:
        d = descriptors[i][np.asarray(masks[i])]
        if len(d) == 0:
            continue
        take = min(len(d), opts.sample_per_image)
        samples.append(d[rng.choice(len(d), take, replace=False)])
    train = np.concatenate(samples, axis=0)
    k = min(opts.vocab_size, max(8, len(train) // 4))
    cents = kmeans_fit(torch.as_tensor(train, device=dev), generator(seed),
                       k, opts.kmeans_iters)
    desc = torch.as_tensor(np.stack([descriptors[i] for i in ids]),
                           device=dev)
    mask = torch.as_tensor(np.stack([masks[i] for i in ids]), device=dev)
    tf = bow_histograms(desc, mask.to(desc.dtype), cents, k).cpu().numpy()

    df = (tf > 0).sum(axis=0)
    idf = np.log(len(ids) / np.maximum(df, 1))
    v = tf * idf[None, :]
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    sim = v @ v.T
    np.fill_diagonal(sim, -1.0)
    return ids, sim


def similarity_pairs(descriptors: dict, masks: dict,
                     opts: RetrievalOptions = RetrievalOptions(),
                     seed: int = 0, device=None) -> list:
    """Top-num_neighbors pairs per image by tf-idf BoW cosine: (i, j,
    score) with i < j, deduplicated, highest score first."""
    ids, sim = bow_similarity_matrix(descriptors, masks, opts, seed, device)
    if len(ids) < 2:
        return []
    pairs = {}
    nn = min(opts.num_neighbors, len(ids) - 1)
    for a in range(len(ids)):
        for b in np.argsort(-sim[a])[:nn]:
            i, j = ids[a], ids[int(b)]
            keyp = (i, j) if i < j else (j, i)
            pairs[keyp] = max(pairs.get(keyp, -1.0), float(sim[a, b]))
    return sorted([(i, j, s) for (i, j), s in pairs.items()],
                  key=lambda t: -t[2])


def exhaustive_pairs(image_ids: list, block_size: int = 50) -> list:
    """All pairs (i, j, 0.0) with i < j (COLMAP ExhaustiveMatchingOptions;
    the block size only groups the work, not the set)."""
    ids = sorted(image_ids)
    return [(ids[a], ids[b], 0.0)
            for a in range(len(ids)) for b in range(a + 1, len(ids))]


def sequential_pairs(image_ids: list, overlap: int = 10,
                     loop_detection_period: int = 0,
                     loop_detection_num_images: int = 50,
                     descriptors: dict | None = None,
                     masks: dict | None = None,
                     retrieval_opts: RetrievalOptions | None = None,
                     seed: int = 0, device=None) -> list:
    """Each frame with its next `overlap` frames, then, every
    `loop_detection_period` frames (0: never), the frame's
    `loop_detection_num_images` most similar frames by BoW that are
    neither temporal neighbours nor already paired (loop closure; needs
    `descriptors` and `masks`, one similarity matrix for all queries)."""
    out = []
    ids = sorted(image_ids)
    have = set()
    for a in range(len(ids)):
        for d in range(1, overlap + 1):
            if a + d < len(ids):
                out.append((ids[a], ids[a + d], 0.0))
                have.add((ids[a], ids[a + d]))

    if loop_detection_period > 0 and descriptors is not None:
        desc_ids, sim = bow_similarity_matrix(
            descriptors, masks, retrieval_opts or RetrievalOptions(),
            seed=seed, device=device)
        row_of = {im: k for k, im in enumerate(desc_ids)}
        seq_pos = {im: k for k, im in enumerate(ids)}
        for a in range(0, len(ids), loop_detection_period):
            if ids[a] not in row_of:
                continue
            ra = row_of[ids[a]]
            added = 0
            for rb in np.argsort(-sim[ra]):
                if added >= loop_detection_num_images:
                    break
                b_id = desc_ids[int(rb)]
                b = seq_pos.get(b_id)
                if b is None or b_id == ids[a] or abs(b - a) <= overlap:
                    continue
                keyp = (ids[a], b_id) if ids[a] < b_id else (b_id, ids[a])
                if keyp in have:
                    continue
                have.add(keyp)
                out.append((keyp[0], keyp[1], float(sim[ra, rb])))
                added += 1
    return out


def spatial_pairs(image_ids: list, locations: np.ndarray,
                  max_num_neighbors: int = 50,
                  max_distance: float = 100.0) -> list:
    """Each image with its nearest `max_num_neighbors` locations within
    `max_distance`: (i, j, -distance), nearest first."""
    ids = sorted(image_ids)
    loc = np.asarray(locations, float)
    d = np.linalg.norm(loc[:, None] - loc[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    out = {}
    for a in range(len(ids)):
        for b in np.argsort(d[a])[:max_num_neighbors]:
            if d[a, b] > max_distance:
                break
            keyp = (ids[a], ids[int(b)]) if ids[a] < ids[int(b)] \
                else (ids[int(b)], ids[a])
            out[keyp] = -float(d[a, b])
    return sorted([(i, j, s) for (i, j), s in out.items()],
                  key=lambda t: -t[2])


def transitive_pairs(matched_pairs: list, num_iterations: int = 3,
                     batch_size: int = 1000) -> list:
    """If (a, b) and (b, c) are matched, propose (a, c); at most
    `batch_size` per iteration. Returns the new pairs only."""
    have = set()
    adj: dict = {}
    for i, j, *_ in matched_pairs:
        a, b = (i, j) if i < j else (j, i)
        have.add((a, b))
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    new_out = []
    for _ in range(num_iterations):
        fresh = []
        for b, nbrs in list(adj.items()):
            ns = sorted(nbrs)
            for x in range(len(ns)):
                for y in range(x + 1, len(ns)):
                    a, c = ns[x], ns[y]
                    if (a, c) not in have:
                        fresh.append((a, c, 0.0))
                        have.add((a, c))
                        if len(fresh) >= batch_size:
                            break
                if len(fresh) >= batch_size:
                    break
            if len(fresh) >= batch_size:
                break
        if not fresh:
            break
        for a, c, _ in fresh:
            adj.setdefault(a, set()).add(c)
            adj.setdefault(c, set()).add(a)
        new_out.extend(fresh)
    return new_out


def pairs_from_file(path: str, name_to_id: dict) -> list:
    """Pairs listed as "name1 name2" per line (`#` comments, unknown
    names and self pairs skipped): (min, max, 0.0)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or line.lstrip().startswith("#"):
                continue
            a, b = name_to_id.get(parts[0]), name_to_id.get(parts[1])
            if a is None or b is None or a == b:
                continue
            out.append((min(a, b), max(a, b), 0.0))
    return out
