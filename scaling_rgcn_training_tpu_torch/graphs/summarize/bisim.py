"""FLUID (k)-forward-bisimulation output -> ``isSummaryOf`` map files.

Reference graphs/createBisimMapping.py:16-113: converts the CSV output of
the external FLUID bisimulation pipeline (per-k folders with
``orgNode_to_orgHash*`` / ``sumNode_to_orgHash*`` files) into `.nt` map
files, with dataset-specific literal/bnode reformatting. The reference's
interactive ``click.confirm`` sanity check becomes a returned mismatch
count (callers decide; no interactive prompt in a framework). A copy of
the JAX package's ``graphs/summarize/bisim.py``; its map files are byte
for byte the same.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_FLUID_BNODE_PREFIX = "http://informatik.uni-kiel.de/fluid#"


def reformat(node: str, dataset: str) -> Optional[str]:
    """Dataset-specific node reformatting (createBisimMapping.py:34-62)."""
    if dataset not in ("AM", "BGS"):
        if "xmlschema" in node:
            split = node.rsplit("^^", 1)
            if len(split) < 2:
                split.insert(0, '""')
                return "^^<".join(split) + ">"
            return "^^".join([split[0], "<" + split[1] + ">"])
        if node.startswith(_FLUID_BNODE_PREFIX):
            return node.replace(_FLUID_BNODE_PREFIX, "_:")
        return "<" + node + ">"
    if dataset == "AM":
        if "http" in node:
            if node.startswith(_FLUID_BNODE_PREFIX):
                return node.replace(_FLUID_BNODE_PREFIX, "_:")
            return "<" + node + ">"
        return node
    return None  # BGS: reference leaves this unimplemented (pass)


def csv_to_mapping(path: str, dataset: str, org: bool = True) -> Dict[str, List[str]]:
    """CSV -> hash mapping (createBisimMapping.py:66-79), incl. its
    rejoin-then-rsplit handling of commas inside node strings."""
    mapping: Dict[str, List[str]] = defaultdict(list)
    with open(path, "rt") as f:
        lines = csv.reader(f, skipinitialspace=False, quotechar=None)
        next(lines)
        for line in lines:
            joined = ",".join(line)
            left, right = joined.rsplit(",", 1)
            if org:
                mapping[right].append(reformat(left, dataset))
            else:
                mapping[left].append(right)
    return mapping


def count_unmatched_nodes(orgHash_to_orgNode: Dict[str, List[str]], org_nt_path: str) -> Tuple[int, int]:
    """(unmatched mapped nodes, total original nodes) — the reference's
    interactive sanity check (createBisimMapping.py:16-31), non-interactive."""
    org_nodes = set()
    with open(org_nt_path, "r") as fh:
        for line in fh.read().splitlines():
            parts = line[:-2].split(" ", maxsplit=2)
            if parts != [""] and len(parts) == 3:
                org_nodes.add(parts[0].lower())
                org_nodes.add(parts[2].lower())
    count = sum(
        1 for nodes in orgHash_to_orgNode.values() for n in nodes if n not in org_nodes)
    return count, len(org_nodes)


def write_to_nt(orgHash_to_orgNode: Dict[str, List[str]],
                sumNode_to_orgHash: Dict[str, List[str]],
                map_path_prefix: str, k: str) -> str:
    out = f"{map_path_prefix}{k}.nt"
    with open(out, "w") as m:
        for sumNode, orgHashes in sumNode_to_orgHash.items():
            for orgHash in orgHashes:
                for node in orgHash_to_orgNode[orgHash]:
                    m.write(f"<{sumNode}> <isSummaryOf> {node} .\n")
    return out


def create_bisim_map_nt(bisim_output_path: str, map_path_prefix: str,
                        dataset: str, org_nt_path: Optional[str] = None) -> List[str]:
    """Convert every per-k FLUID output folder (createBisimMapping.py:93-107)."""
    written = []
    dirs = sorted(
        x for x in os.listdir(bisim_output_path)
        if not x.startswith(".") and os.path.isdir(os.path.join(bisim_output_path, x)))
    for d in dirs:
        full = os.path.join(bisim_output_path, d)
        orgHash_to_orgNode: Dict[str, List[str]] = {}
        sumNode_to_orgHash: Dict[str, List[str]] = {}
        for f in sorted(x for x in os.listdir(full) if not x.startswith(".")):
            if f.startswith("orgNode"):
                orgHash_to_orgNode = csv_to_mapping(os.path.join(full, f), dataset)
            else:
                sumNode_to_orgHash = csv_to_mapping(os.path.join(full, f), dataset, org=False)
        if org_nt_path:
            unmatched, total = count_unmatched_nodes(orgHash_to_orgNode, org_nt_path)
            if unmatched:
                print(f"{unmatched} mapped (probably literal) nodes do not match "
                      f"original nodes (of {total}).")
        k = d.split("_")[-1]
        written.append(write_to_nt(orgHash_to_orgNode, sumNode_to_orgHash, map_path_prefix, k))
    return written
