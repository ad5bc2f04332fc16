"""Random "dummy" summaries (reference graphs/createDummySum.py:6-37).

Control experiment: every node gets a uniform-random summary id in
``[0, n_sum_nodes]`` — tests whether summary *structure* (vs. mere
dimensionality reduction) is what transfers. A copy of the JAX package's
``graphs/summarize/dummy.py``: Python's ``random.Random(seed)`` draws the
ids, so a seed writes the same bytes in both packages.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List


def _parse(line: str):
    parts = line[:-2].split(" ", maxsplit=2)
    if parts == [""] or len(parts) < 3:
        return None
    # NOTE: the reference does NOT lowercase here (createDummySum.py:13-15)
    return parts[0], parts[1], parts[2]


def create_dummy_sum_map(path: str, sum_path: str, map_path: str, dataset: str,
                         n_sum_nodes: int, seed: int | None = None) -> None:
    rng = random.Random(seed)
    node_to_sum: Dict[str, int] = {}
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    for line in lines:
        t = _parse(line)
        if t is None:
            continue
        s, _, o = t
        for node in (s, o):
            if node not in node_to_sum:
                node_to_sum[node] = rng.randint(0, n_sum_nodes)

    os.makedirs(sum_path, exist_ok=True)
    os.makedirs(map_path, exist_ok=True)
    write_sum_map_files(
        node_to_sum, lines,
        os.path.join(sum_path, f"{dataset}_sum_random{n_sum_nodes}.nt"),
        os.path.join(map_path, f"{dataset}_map_random{n_sum_nodes}.nt"))


def write_sum_map_files(node_to_sum: Dict[str, int], lines: List[str],
                        sum_file: str, map_file: str) -> None:
    with open(sum_file, "w") as f:
        for line in lines:
            t = _parse(line)
            if t is None:
                continue
            s, p, o = t
            f.write(f"<{node_to_sum[s]}> {p} <{node_to_sum[o]}> .\n")
    with open(map_file, "w") as m:
        for node, sum_id in node_to_sum.items():
            m.write(f"<{sum_id}> <isSummaryOf> {node} .\n")
