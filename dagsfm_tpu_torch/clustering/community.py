"""Greedy modularity community detection (host).

Port of dagsfm_tpu/clustering/community.py: the Clauset-Newman-Moore
merge loop over a heap, copied as it is (labels identical).
"""

from __future__ import annotations

import heapq

import numpy as np


def community_detection(edges: np.ndarray, weights: np.ndarray,
                        num_nodes: int) -> np.ndarray:
    """CNM greedy modularity maximization. Ignores a target cluster count
    (like the reference, community_detection_cluster.cpp ignores
    num_partitions). Returns labels (num_nodes,)."""
    m2 = float(np.sum(weights)) * 2.0
    if m2 <= 0 or num_nodes == 0:
        return np.zeros(num_nodes, np.int32)

    # community state: each node starts alone
    comm_of = list(range(num_nodes))
    comms: dict[int, set] = {i: {i} for i in range(num_nodes)}
    # community degree (sum of incident edge weights, both endpoints)
    a = np.zeros(num_nodes)
    # inter-community weights e[ci][cj]
    e: dict[int, dict] = {i: {} for i in range(num_nodes)}
    for (i, j), w in zip(np.asarray(edges), np.asarray(weights, float)):
        i, j = int(i), int(j)
        if i == j:
            continue
        a[i] += w
        a[j] += w
        e[i][j] = e[i].get(j, 0.0) + w
        e[j][i] = e[j].get(i, 0.0) + w

    def dq(ci, cj):
        return 2.0 * (e[ci].get(cj, 0.0) / m2 - (a[ci] / m2) * (a[cj] / m2))

    heap = []
    for ci in e:
        for cj in e[ci]:
            if ci < cj:
                heapq.heappush(heap, (-dq(ci, cj), ci, cj))

    alive = set(range(num_nodes))
    while heap:
        negdq, ci, cj = heapq.heappop(heap)
        if -negdq <= 0:
            break
        if ci not in alive or cj not in alive:
            continue
        # stale entry check
        if abs(-negdq - dq(ci, cj)) > 1e-12:
            heapq.heappush(heap, (-dq(ci, cj), ci, cj))
            continue
        # merge cj into ci
        comms[ci] |= comms.pop(cj)
        alive.discard(cj)
        for n in comms[ci]:
            comm_of[n] = ci
        for ck, w in list(e[cj].items()):
            if ck == ci:
                continue
            e[ci][ck] = e[ci].get(ck, 0.0) + w
            e[ck][ci] = e[ck].get(ci, 0.0) + w
            e[ck].pop(cj, None)
        e[ci].pop(cj, None)
        e.pop(cj, None)
        a[ci] += a[cj]
        a[cj] = 0.0
        for ck in e[ci]:
            if ck in alive:
                lo, hi = min(ci, ck), max(ci, ck)
                heapq.heappush(heap, (-dq(lo, hi), lo, hi))

    # relabel densely
    labels = np.zeros(num_nodes, np.int32)
    remap = {}
    for n in range(num_nodes):
        c = comm_of[n]
        if c not in remap:
            remap[c] = len(remap)
        labels[n] = remap[c]
    return labels


def modularity(edges, weights, labels) -> float:
    labels = np.asarray(labels)
    w = np.asarray(weights, float)
    m2 = w.sum() * 2.0
    if m2 <= 0:
        return 0.0
    a = {}
    intra = 0.0
    for (i, j), wt in zip(np.asarray(edges), w):
        a[labels[i]] = a.get(labels[i], 0.0) + wt
        a[labels[j]] = a.get(labels[j], 0.0) + wt
        if labels[i] == labels[j]:
            intra += wt
    q = 2.0 * intra / m2
    for c, ac in a.items():
        q -= (ac / m2) ** 2
    return q
