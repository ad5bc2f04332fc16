"""A knowledge graph's triples, drawn from a seed.

The configuration fixes the counts (entities, relations, triples); the
mix fixes how endpoints and relations are spread over them. The one
spread so far, ``"draw": "iid"``: each subject, object and relation drawn
uniformly on its own, as ``rehearse_am.py`` draws them. A skewed spread
waits for a published degree statistic of the graph it stands for.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

# the stream of the seed that draws the graph
STREAM = 1
DRAWS = ("iid",)


def triples(traffic: Dict[str, Any], config: Dict[str, Any],
            seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(subject, relation, object)`` int32 ``[T]``."""
    draws = {traffic["endpoints"]["draw"], traffic["relations"]["draw"]}
    if not draws <= set(DRAWS):
        raise ValueError(f"unknown draw in {sorted(draws)}")
    n, r, t = (int(config[k]) for k in ("num_entities", "num_relations",
                                          "num_triples"))
    rng = np.random.default_rng(np.random.SeedSequence([seed, STREAM]))
    subj, obj = rng.integers(0, n, t), rng.integers(0, n, t)
    rel = rng.integers(0, r, t)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return as32(subj), as32(rel), as32(obj)
