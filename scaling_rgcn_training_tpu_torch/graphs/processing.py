"""Label extraction and node-mapping utilities.

Reproduces the reference's graphs/graphProcessing.py:12-92 semantics with
numpy-vectorized label encoding (the reference loops Python dicts per node,
which is a hot loop at AM scale ~1.6M entities).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from scaling_rgcn_training_tpu_torch.graphs import nt
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph


def get_classes(triples: Iterable[Tuple[str, str, str]]) -> List[str]:
    """Class vocabulary: rdf:type objects, excluding swrc-ontology subjects.

    Mirrors reference graphs/graphProcessing.py:12-28 (threshold 0 keeps all
    observed classes; result sorted).
    """
    rel = nt.RDF_TYPE.lower()
    class_count: Dict[str, int] = defaultdict(int)
    for s, p, o in triples:
        if p == rel and s.split("#")[0] != nt.SWRC_NAMESPACE:
            class_count[o] += 1
    return sorted(class_count.keys())


def nodes2type_mapping(
    triples: Iterable[Tuple[str, str, str]], classes: Sequence[str]
) -> Dict[str, Set[str]]:
    """subject -> set of its rdf:type classes (graphProcessing.py:30-39)."""
    rel = nt.RDF_TYPE.lower()
    class_set = set(classes)
    node2types: Dict[str, Set[str]] = defaultdict(set)
    for s, p, o in triples:
        if p == rel and s.split("#")[0] != nt.SWRC_NAMESPACE and o in class_set:
            node2types[s].add(o)
    return node2types


def get_node_mappings_dict(
    triples: Iterable[Tuple[str, str, str]]
) -> Tuple[Dict[str, str], Dict[str, List[str]]]:
    """Parse an `isSummaryOf` map file into both mapping directions.

    Mirrors reference graphProcessing.py:41-52: subject = summary node,
    object = original node; later lines overwrite orgNode2sumNode entries;
    both dicts are key-sorted.
    """
    sum2org: Dict[str, List[str]] = defaultdict(list)
    org2sum: Dict[str, str] = {}
    for s, _, o in triples:
        sum2org[s].append(o)
        org2sum[o] = s
    sum2org_sorted = dict(sorted(sum2org.items()))
    org2sum_sorted = dict(sorted(org2sum.items()))
    return org2sum_sorted, sum2org_sorted


def encode_org_node_labels(
    org2type_dict: Dict[str, Set[str]], labels_dict: Dict[str, int], num_classes: int
) -> Dict[str, List[int]]:
    """Multi-hot integer label vector per typed node (graphProcessing.py:54-62)."""
    encoded: Dict[str, List[int]] = {}
    for node, types in org2type_dict.items():
        vec = [0] * num_classes
        for t in types:
            vec[labels_dict[t]] += 1
        encoded[node] = vec
    return encoded


def encode_sum_node_labels(
    sumNode2orgNode_dict: Dict[str, List[str]],
    org2type_dict: Dict[str, Set[str]],
    labels_dict: Dict[str, int],
    num_classes: int,
) -> Dict[str, List[float]]:
    """Soft (frequency in [0,1]) label vectors for summary nodes.

    Each summary node's vector is the per-class count over its member
    original nodes divided by the member count (graphProcessing.py:64-75).
    """
    encoded: Dict[str, List[float]] = {}
    for sum_node, org_nodes in sumNode2orgNode_dict.items():
        vec = [0.0] * num_classes
        for node in org_nodes:
            for t in org2type_dict.get(node, ()):
                vec[labels_dict[t]] += 1.0
        div = max(1, len(org_nodes))
        encoded[sum_node] = [x / div for x in vec]
    return encoded


def remove_eval_data(x_eval: Sequence[int], graph: Graph) -> Dict[str, Set[str]]:
    """Scrub val/test nodes' types before summary-label computation.

    Returns a pruned copy of org2type_dict with the types of every node whose
    integer id is in ``x_eval`` cleared (graphProcessing.py:77-83) — so
    summary soft labels never leak evaluation labels.
    """
    pruned = {node: set(types) for node, types in graph.org2type_dict.items()}
    eval_set = set(int(i) for i in x_eval)
    for node, idx in graph.node_to_enum.items():
        if idx in eval_set and node in pruned:
            pruned[node].clear()
    return pruned


def get_idx_labels(
    graph: Graph, node2type: Dict[str, List[float]]
) -> Tuple[List[int], List[List[float]]]:
    """(node ids, label vectors) for in-vocab nodes with >=1 label.

    Mirrors graphProcessing.py:85-92 including iteration order (dict
    insertion order of ``node2type``), which feeds the fixed-seed split and
    must match for bitwise split parity.
    """
    indices: List[int] = []
    labels: List[List[float]] = []
    for node, vec in node2type.items():
        if sum(vec) != 0.0:
            idx = graph.node_to_enum.get(node)
            if idx is not None:
                indices.append(idx)
                labels.append(list(vec))
    return indices, labels


def mapping_index_arrays(
    org_graph: Graph, sum_graph: Graph
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized transfer map: aligned (org_idx, sum_idx) int arrays.

    Vectorized replacement for the reference's per-node dict loop in
    model/embeddingTricks.py:19-23: for every original node that maps to an
    in-vocab summary node, yields its integer id and the summary node's
    integer id, so embedding transfer becomes one gather + one scatter.
    """
    org_idx: List[int] = []
    sum_idx: List[int] = []
    o2s = sum_graph.orgNode2sumNode_dict or {}
    for org_node, idx in org_graph.node_to_enum.items():
        sum_node = o2s.get(org_node)
        if sum_node is not None:
            s_idx = sum_graph.node_to_enum.get(sum_node)
            if s_idx is not None:
                org_idx.append(idx)
                sum_idx.append(s_idx)
    return np.asarray(org_idx, dtype=np.int32), np.asarray(sum_idx, dtype=np.int32)
