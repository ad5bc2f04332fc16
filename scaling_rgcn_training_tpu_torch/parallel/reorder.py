"""Locality-aware node reordering for the halo partition.

Copy of the JAX package's ``parallel/reorder.py`` (numpy only), with one
fix: ``_max_peer_halo`` builds its (reader, owner, source) key in int64
after relabeling, where the original overflowed int32 once S^2 * N > 2^31.

The halo partition (``parallel/halo.py``) assigns contiguous node ranges to
shards, so its exchange traffic is the number of distinct remote sources
each shard reads — the edge cut of the *node numbering*. RDF graphs come
numbered by sorted IRI (graphs/graph.py vocab order), which is
uncorrelated with topology; a clustering reorder maps communities to
contiguous ranges and shrinks the cut.

This is a stand-in for the partitioner inside distributed GNN systems
(METIS in DistDGL etc.) — implemented from scratch as
vectorized numpy label propagation (no external deps, runs once per graph
on the host; the reference has nothing like it — it is single-device,
model/modelTrainer.py:16).

Algorithm: synchronous label propagation over the undirected edge set.
Every node starts with its own label; each round it adopts the most
frequent label among its neighbors (ties -> smaller label). Communities
converge in a handful of rounds; the new numbering sorts nodes by final
label. Each round is one O(E log E) sort — no Python per-node loops.
"""

from __future__ import annotations

import numpy as np


def _majority_label(u: np.ndarray, nbr_label: np.ndarray,
                    labels: np.ndarray) -> np.ndarray:
    """For each node, the most frequent label among its neighbors.

    ``u``: edge endpoints (int64, one row per directed edge), ``nbr_label``
    the label at the other endpoint. Nodes without edges keep their label.
    """
    n = labels.shape[0]
    key = u * np.int64(n) + nbr_label
    uniq, counts = np.unique(key, return_counts=True)
    ku = uniq // n
    kl = uniq % n
    # per node, pick the (count, -label)-max entry: sort by (node, count,
    # -label) and take the last row of each node group
    order = np.lexsort((-kl, counts, ku))
    ku, kl = ku[order], kl[order]
    last = np.flatnonzero(np.diff(ku, append=np.int64(-1)) != 0)
    out = labels.copy()
    out[ku[last]] = kl[last]
    return out


def _pack_communities(labels: np.ndarray, src: np.ndarray, dst: np.ndarray,
                      num_nodes: int, num_shards: int) -> np.ndarray:
    """Bin-pack communities into shard-sized contiguous ranges.

    The halo buffer (``parallel/halo.py``) is the MAX over (reader, owner)
    pairs of distinct remote sources — so a single community straddling a
    shard boundary dominates it: every intra-community edge across the
    split lands on one pair. Plain label-sorted numbering straddles almost
    every community (sizes don't divide the shard capacity). Packing whole
    communities into shards first-fit-decreasing removes all straddles
    except the forced capacity residue; that residue is chosen as each
    split community's LOWEST-intra-degree nodes, so the spilled fragment
    carries as few cross-split edges as possible.
    """
    s_n = num_shards
    n_per = -(-num_nodes // s_n)
    caps = np.full(s_n, n_per, np.int64)
    caps[-1] = num_nodes - (s_n - 1) * n_per
    # undirected intra-community degree: the cost of displacing a node
    same = labels[src] == labels[dst]
    deg = (np.bincount(src[same], minlength=num_nodes)
           + np.bincount(dst[same], minlength=num_nodes)).astype(np.int64)
    # nodes grouped by community, strongest-attached first within each —
    # splits then spill only the weakly-attached tail
    order = np.lexsort((np.arange(num_nodes), -deg, labels))
    lab_sorted = labels[order]
    starts = np.flatnonzero(np.r_[True, np.diff(lab_sorted) != 0])
    ends = np.r_[starts[1:], num_nodes]
    sizes = ends - starts
    big = sizes >= max(2, n_per // 64)
    bins: list[list[np.ndarray]] = [[] for _ in range(s_n)]
    for ci in np.flatnonzero(big)[np.argsort(-sizes[big], kind="stable")]:
        seg = order[starts[ci]:ends[ci]]
        while len(seg):
            b = int(np.argmax(caps))
            take = int(min(caps[b], len(seg)))
            bins[b].append(seg[:take])
            caps[b] -= take
            seg = seg[take:]
    # residue stream: tiny communities, label-adjacent (so most stay whole)
    resid = order[~np.repeat(big, sizes)]
    pos = 0
    for b in range(s_n):
        if caps[b] > 0:
            bins[b].append(resid[pos:pos + caps[b]])
            pos += int(caps[b])
            caps[b] = 0
    perm = np.empty(num_nodes, np.int64)
    for b in range(s_n):
        ids = np.concatenate(bins[b]) if bins[b] else np.empty(0, np.int64)
        perm[ids] = b * n_per + np.arange(len(ids))
    return perm.astype(np.int32)


def locality_reorder(edge_src: np.ndarray, edge_dst: np.ndarray,
                     num_nodes: int, rounds: int = 30,
                     num_shards: int | None = None) -> np.ndarray:
    """-> ``perm`` with ``perm[old_id] = new_id`` (a relabeling).

    Label-propagation clustering: nodes in the same community land in one
    contiguous block of new ids, so contiguous-range partitions cut few
    edges on community-structured graphs (most real RDF KGs). On a
    locality-free random graph the cut is provably ~(S-1)/S for any
    numbering — the reorder is a no-op there, not a regression.

    With ``num_shards`` the numbering is additionally shard-aware: whole
    communities are bin-packed into shard-sized ranges so none straddles a
    shard boundary (see :func:`_pack_communities`) — this is what shrinks
    the halo MAX, not just the average edge cut.
    """
    src = np.asarray(edge_src, np.int64)
    dst = np.asarray(edge_dst, np.int64)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    labels = np.arange(num_nodes, dtype=np.int64)
    for _ in range(rounds):
        new = _majority_label(u, labels[v], labels)
        if np.array_equal(new, labels):
            break
        labels = new
    if num_shards is not None and num_shards > 1:
        perm = _pack_communities(labels, src, dst, num_nodes, num_shards)
        # guard: on a locality-free graph the clustering finds phantom
        # structure and community packing can INFLATE the halo max
        # (measured at AM shape: 122k -> 165k rows/peer on a uniform
        # graph). Keep the relabeling only if it shrinks the metric that
        # matters — the max per-(reader, owner) unique boundary rows,
        # which is exactly the halo buffer H the partition allocates.
        if _max_peer_halo(src, dst, num_nodes, num_shards, perm) \
                < _max_peer_halo(src, dst, num_nodes, num_shards, None):
            return perm
        return np.arange(num_nodes, dtype=np.int32)
    # new id = rank under (label, old id): communities contiguous,
    # deterministic within a community
    order = np.lexsort((np.arange(num_nodes), labels))
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm.astype(np.int32)


def _max_peer_halo(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   num_shards: int, perm: np.ndarray | None) -> int:
    """Max over (reader, owner) shard pairs of unique remote source rows —
    the halo buffer size H the contiguous-range partition allocates."""
    if perm is not None:
        src, dst = perm[src], perm[dst]
    # int64 keys: perm is int32, and the pair key reaches S^2 * N
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_per = -(-num_nodes // num_shards)
    so = src // n_per
    do = dst // n_per
    cross = so != do
    if not cross.any():
        return 0
    pair = (do[cross] * num_shards + so[cross]) * num_nodes + src[cross]
    pairs = np.unique(pair)
    counts = np.bincount(pairs // num_nodes,
                         minlength=num_shards * num_shards)
    return int(counts.max())


def edge_cut_fraction(edge_src: np.ndarray, edge_dst: np.ndarray,
                      num_nodes: int, num_shards: int,
                      perm: np.ndarray | None = None) -> float:
    """Fraction of edges whose src and dst land on different shards
    under the contiguous-range partition (after optional relabeling)."""
    src = np.asarray(edge_src, np.int64)
    dst = np.asarray(edge_dst, np.int64)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        src, dst = perm[src], perm[dst]
    n_per = -(-num_nodes // num_shards)
    return float(np.mean(src // n_per != dst // n_per))
