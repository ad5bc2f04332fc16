"""Dataset assembly: original graph + summary graphs + train/val/test splits.

Reproduces reference graphs/dataset.py:13-97 semantics:
- class vocab + node->types mapping from the original graph's triples;
- every (sum, map) file pair in sorted order becomes a summary Graph with
  its node mapping dicts;
- 60/20/20 train/test/val split with the index order of two sklearn
  ``train_test_split`` calls with ``random_state=1, shuffle=True``
  (dataset.py:27-28), computed here in numpy (:func:`train_test_split`) —
  bitwise split parity with the reference without sklearn;
- summary node soft labels computed AFTER scrubbing val/test node types
  (dataset.py:50-56), so evaluation labels never leak into pre-training;
- asserts summary relation count == original relation count (dataset.py:63).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from scaling_rgcn_training_tpu_torch.graphs import nt
from scaling_rgcn_training_tpu_torch.graphs import processing as proc
from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu.utils import timing


def train_test_split(x, y, test_size: float, seed: int = 1):
    """sklearn ``train_test_split(x, y, test_size=..., random_state=seed,
    shuffle=True)``: one ``RandomState(seed).permutation``, the first
    ``ceil(test_size * n)`` indices are the test split, the rest train.
    Returns ``(x_train, x_test, y_train, y_test)`` as lists."""
    n = len(x)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return ([x[i] for i in train], [x[i] for i in test],
            [y[i] for i in train], [y[i] for i in test])


class Dataset:
    """Original graph + its summary graphs, with training tensors attached."""

    def __init__(self, org_path: str, sum_path: Optional[str] = None, map_path: Optional[str] = None) -> None:
        self.org_path = org_path
        self.sum_path = sum_path
        self.map_path = map_path
        self.sumGraphs: List[Graph] = []
        self.orgGraph: Optional[Graph] = None
        self.enum_classes: Optional[Dict[str, int]] = None
        self.num_classes: Optional[int] = None

    # -- file discovery (reference dataset.py:65-69) -----------------------

    def get_file_names(self) -> Tuple[List[str], List[str]]:
        sum_files = sorted(
            f for f in os.listdir(self.sum_path)
            if not f.startswith(".") and os.path.isfile(os.path.join(self.sum_path, f))
        )
        map_files = sorted(
            f for f in os.listdir(self.map_path)
            if not f.startswith(".") and os.path.isfile(os.path.join(self.map_path, f))
        )
        assert len(sum_files) == len(map_files), (
            f"for every summary file there needs to be a map file: {sum_files} / {map_files}"
        )
        return sum_files, map_files

    # -- assembly ----------------------------------------------------------

    def init_dataset(self, verbose: bool = True) -> "Dataset":
        name = self.org_path.split("/")[-1]
        self.orgGraph = Graph(name)
        org_triples = nt.read_triples(self.org_path)
        classes = proc.get_classes(org_triples)
        org2type_dict = proc.nodes2type_mapping(org_triples, classes)
        self.orgGraph.init_from_triples(
            org_triples, nt.count_unique_lines(self.org_path))
        self.enum_classes = {c: i for i, c in enumerate(classes)}
        self.num_classes = len(classes)
        self.orgGraph.org2type_dict = {k: set(v) for k, v in org2type_dict.items()}

        if self.sum_path is not None:
            sum_files, map_files = self.get_file_names()
            for sum_f, map_f in zip(sum_files, map_files):
                sg = Graph(sum_f, org2type_dict={k: set(v) for k, v in org2type_dict.items()})
                sum_file = os.path.join(self.sum_path, sum_f)
                sg.init_from_triples(
                    nt.read_triples(sum_file), nt.count_unique_lines(sum_file))
                m_triples = nt.read_triples(os.path.join(self.map_path, map_f))
                sg.orgNode2sumNode_dict, sg.sumNode2orgNode_dict = proc.get_node_mappings_dict(m_triples)
                self.sumGraphs.append(sg)

        self.make_training_data(verbose=verbose)
        return self

    def make_training_data(self, verbose: bool = True) -> None:
        """Label encoding + fixed-seed splits (reference dataset.py:23-63)."""
        og = self.orgGraph
        og.org2type = proc.encode_org_node_labels(
            og.org2type_dict, self.enum_classes, self.num_classes)

        g_idx, g_labels = proc.get_idx_labels(og, og.org2type)
        X_train, X_test, y_train, y_test = train_test_split(
            g_idx, g_labels, test_size=0.2)
        X_train, X_val, y_train, y_val = train_test_split(
            X_train, y_train, test_size=0.25)

        og.x_train = np.asarray(X_train, np.int32)
        og.y_train = np.asarray(y_train, np.float32)
        og.x_val = np.asarray(X_val, np.int32)
        og.y_val = np.asarray(y_val, np.float32)
        og.x_test = np.asarray(X_test, np.int32)
        og.y_test = np.asarray(y_test, np.float32)

        if verbose:
            print("ORIGINAL GRAPH STATISTICS")
            print(f"file name = {og.name}")
            print(f"num Nodes = {og.num_nodes}")
            print(f"num Edges = {og.num_edges}")
            print(f"num Relations = {og.num_relations}")
            print(f"num Classes = {self.num_classes}")
            timing.log("ORIGINAL GRAPH LOADED")

        # scrub evaluation labels before computing summary soft labels
        to_remove = list(X_test) + list(X_val)
        org2type_pruned = proc.remove_eval_data(to_remove, og)

        for sg in self.sumGraphs:
            sg.sum2type = proc.encode_sum_node_labels(
                sg.sumNode2orgNode_dict, org2type_pruned, self.enum_classes, self.num_classes)
            sg_idx, sg_labels = proc.get_idx_labels(sg, sg.sum2type)
            sg.x_train = np.asarray(sg_idx, np.int32)
            sg.y_train = np.asarray(sg_labels, np.float32)
            if verbose:
                print("SUMMARY GRAPH STATISTICS")
                print(f"file name = {sg.name}")
                print(f"num Nodes = {sg.num_nodes}")
                print(f"num Edges = {sg.num_edges}")
                print(f"num Relations = {sg.num_relations}")
                timing.log("SUMMARY GRAPH LOADED")
            assert sg.num_relations == og.num_relations, (
                "number of relations in summary graph and original graph differ")
