"""Attribute summarization (reference graphs/createAttributeSum.py:6-79).

Per entity: the set of outgoing / incoming predicate labels (rdf:type edges
excluded; every literal object collapses onto the single node
``http://example.org/literal``). Summary node id = 128-bit murmur hash of
the sorted, comma-joined predicate set; the in_out variant ADDS the two
hashes (createAttributeSum.py:33-38). Every original triple is rewritten
with summary ids (structure-preserving: same line count), plus an
``isSummaryOf`` map file per variant.

Byte-compatible with the reference's output (validated against the
committed TEST fixture, which the reference generated with real mmh3).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from scaling_rgcn_training_tpu_torch.graphs.summarize.murmur import hash128

_TYPE_PRED = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
_LITERAL_NODE = "http://example.org/literal"


def _parse(line: str):
    parts = line[:-2].split(" ", maxsplit=2)
    if parts == [""] or len(parts) < 3:
        return None
    return parts[0].lower(), parts[1].lower(), parts[2].lower()


def create_sum_map(path: str, sum_path: str, map_path: str, dataset: str) -> None:
    outgoing: Dict[str, set] = defaultdict(set)
    incoming: Dict[str, set] = defaultdict(set)

    with open(path, "r") as fh:
        triples = fh.read().splitlines()
    for line in triples:
        t = _parse(line)
        if t is None:
            continue
        s, p, o = t
        if p != _TYPE_PRED:
            outgoing[s].add(p)
            if o.startswith('"'):
                incoming[_LITERAL_NODE].add(p)
            else:
                incoming[o].add(p)

    def hash_sets(props: Dict[str, set]) -> Dict[str, int]:
        return {k: hash128(",".join(sorted(v)).encode("utf8")) for k, v in props.items()}

    out_h = hash_sets(outgoing)
    in_h = hash_sets(incoming)
    in_out_h: Dict[str, int] = {}
    for entity in set(incoming).union(outgoing):
        # in_out combines by integer ADDITION of the two hashes
        in_out_h[entity] = in_h.get(entity, 0) + out_h.get(entity, 0)

    os.makedirs(sum_path, exist_ok=True)
    os.makedirs(map_path, exist_ok=True)
    write_sum_map_files(out_h, triples,
                        os.path.join(sum_path, f"{dataset}_sum_out.nt"),
                        os.path.join(map_path, f"{dataset}_map_out.nt"))
    write_sum_map_files(in_h, triples,
                        os.path.join(sum_path, f"{dataset}_sum_in.nt"),
                        os.path.join(map_path, f"{dataset}_map_in.nt"))
    write_sum_map_files(in_out_h, triples,
                        os.path.join(sum_path, f"{dataset}_sum_in_out.nt"),
                        os.path.join(map_path, f"{dataset}_map_in_out.nt"))


def write_sum_map_files(property_hashes: Dict[str, int], triples: List[str],
                        sum_file: str, map_file: str) -> None:
    """Rewrite every triple with summary ids; unmapped nodes become ``<0>``
    (the convention visible in the TEST fixture's map files)."""
    mapping: Dict[str, object] = {}
    with open(sum_file, "w") as f:
        for line in triples:
            t = _parse(line)
            if t is None:
                continue
            s, p, o = t
            if o.startswith('"') and _LITERAL_NODE in property_hashes:
                obj = property_hashes[_LITERAL_NODE]
            else:
                obj = property_hashes[o] if o in property_hashes else "0"
            sub = property_hashes[s] if s in property_hashes else "0"
            mapping[s] = sub
            mapping[o] = obj
            f.write(f"<{sub}> {p} <{obj}> .\n")

    with open(map_file, "w") as m:
        for o_node, s_node in mapping.items():
            m.write(f"<{s_node}> <isSummaryOf> {o_node} .\n")
