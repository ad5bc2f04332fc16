"""Graph container: vocab build + relational edge list as numpy arrays.

Reproduces the reference ``Graph`` semantics (graphs/graph.py:8-69) with
edges as flat numpy int32 arrays instead of a PyG ``Data(edge_index,
edge_type)`` object (a copy of the JAX package's pure-Python parser path;
the C++ parser binding is not ported yet).

Semantics preserved from the reference:
- node vocab = sorted union of subjects and objects over *all* triples,
  including objects of rdf:type triples (graphs/graph.py:46-47);
- relation vocab = predicates minus the rdf:type predicates
  (graphs/graph.py:41-44); we sort it for determinism (the reference
  enumerates a Python set, which is hash-order dependent — only the count is
  semantically meaningful, and dataset.py:63 asserts counts match);
- every triple whose s/p/o are all in-vocab contributes a forward edge with
  type ``2*rel`` and an inverse edge with type ``2*rel + 1``
  (graphs/graph.py:60-63); duplicate lines contribute duplicate edges;
- ``num_edges`` counts *unique* raw lines (graphs/graph.py:29,39).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scaling_rgcn_training_tpu_torch.graphs import nt


class Graph:
    """One (original or summary) RDF graph with integer vocabularies."""

    def __init__(self, name: str, org2type_dict: Optional[Dict[str, set]] = None) -> None:
        self.name = name
        self.nodes: List[str] = []
        self.node_to_enum: Dict[str, int] = {}
        self.num_nodes: int = 0
        self.num_edges: int = 0
        self.relations: Dict[str, int] = {}
        # edges: int32 arrays; edge_type in [0, 2*num_relations)
        self.edge_src: np.ndarray = np.zeros(0, np.int32)
        self.edge_dst: np.ndarray = np.zeros(0, np.int32)
        self.edge_type: np.ndarray = np.zeros(0, np.int32)
        # summary-graph mapping dicts (graphs/graph.py:16-17)
        self.orgNode2sumNode_dict: Optional[Dict[str, str]] = None
        self.sumNode2orgNode_dict: Optional[Dict[str, List[str]]] = None
        # node -> set of class labels (graphs/graph.py:18-20)
        self.org2type_dict = org2type_dict
        self.org2type: Optional[Dict[str, List[float]]] = None
        self.sum2type: Optional[Dict[str, List[float]]] = None
        # training tensors (filled by Dataset.make_training_data)
        self.x_train: Optional[np.ndarray] = None
        self.y_train: Optional[np.ndarray] = None
        self.x_val: Optional[np.ndarray] = None
        self.y_val: Optional[np.ndarray] = None
        self.x_test: Optional[np.ndarray] = None
        self.y_test: Optional[np.ndarray] = None
        # trained summary embedding, set by Trainer.train_summaries
        # (reference: model/modelTrainer.py:82)
        self.embedding = None

    # -- construction ------------------------------------------------------

    def init_graph(self, lines: Sequence[str]) -> None:
        """Build vocab + doubled edge list from raw .nt lines.

        Mirrors reference graphs/graph.py:24-69 with a single vectorized pass.
        """
        triples: List[Tuple[str, str, str]] = []
        subjects: set = set()
        predicates: set = set()
        objects: set = set()
        for line in lines:
            t = nt.split_triple(line)
            if t is None:
                continue
            s, p, o = t
            triples.append(t)
            subjects.add(s)
            predicates.add(p)
            objects.add(o)

        self.num_edges = len(set(lines))

        for type_pred in nt.TYPE_PREDICATES:
            predicates.discard(type_pred)

        self.nodes = sorted(subjects.union(objects))
        self.num_nodes = len(self.nodes)
        self.node_to_enum = {node: i for i, node in enumerate(self.nodes)}
        self.relations = {rel: i for i, rel in enumerate(sorted(predicates))}

        self._build_edges(triples)

    def init_from_triples(self, triples: Sequence[Tuple[str, str, str]], num_unique_lines: int) -> None:
        """Same as init_graph but from pre-parsed triples."""
        subjects: set = set()
        predicates: set = set()
        objects: set = set()
        for s, p, o in triples:
            subjects.add(s)
            predicates.add(p)
            objects.add(o)
        self.num_edges = num_unique_lines
        for type_pred in nt.TYPE_PREDICATES:
            predicates.discard(type_pred)
        self.nodes = sorted(subjects.union(objects))
        self.num_nodes = len(self.nodes)
        self.node_to_enum = {node: i for i, node in enumerate(self.nodes)}
        self.relations = {rel: i for i, rel in enumerate(sorted(predicates))}
        self._build_edges(triples)

    def _build_edges(self, triples: Sequence[Tuple[str, str, str]]) -> None:
        """Doubled (forward 2r / inverse 2r+1) edge arrays (graphs/graph.py:56-63)."""
        n2e, rels = self.node_to_enum, self.relations
        src: List[int] = []
        dst: List[int] = []
        typ: List[int] = []
        for s, p, o in triples:
            r = rels.get(p)
            if r is None:
                continue
            si = n2e.get(s)
            oi = n2e.get(o)
            if si is None or oi is None:
                continue
            # forward: s -> o with type 2r; inverse: o -> s with type 2r+1
            src.append(si)
            dst.append(oi)
            typ.append(2 * r)
            src.append(oi)
            dst.append(si)
            typ.append(2 * r + 1)
        self.edge_src = np.asarray(src, dtype=np.int32)
        self.edge_dst = np.asarray(dst, dtype=np.int32)
        self.edge_type = np.asarray(typ, dtype=np.int32)

    # -- derived quantities ------------------------------------------------

    @property
    def num_relations(self) -> int:
        return len(self.relations)

    @property
    def num_relation_slots(self) -> int:
        """Number of weight slots the models allocate: 2R+1.

        The reference instantiates RGCNConv with ``2*R + 1`` relations
        (model/modelTrainer.py:78,92); the final slot never receives edges
        (self-connections go through the root weight) but the weight tensor
        carries it, so parity requires we do too.
        """
        return 2 * self.num_relations + 1
