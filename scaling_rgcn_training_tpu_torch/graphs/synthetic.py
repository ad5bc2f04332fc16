"""Synthetic RDF knowledge-graph generator.

The reference's original datasets (AIFB/MUTAG/AM ``*_complete.nt``) are
missing git-LFS blobs in this checkout, so full-scale accuracy and
throughput work runs on synthetic graphs with the same shape of signal:

- entities with a latent class; a configurable fraction carries an
  ``rdf:type`` triple (the prediction target, multi-label capable);
- per-relation edges with class-homophily (edges prefer same-class
  endpoints), so a relational message passer genuinely beats chance;
- class-discriminative relation usage (``rel_signal``): each class prefers
  its own subset of relations, mirroring how real RDF schemas make the
  incident-relation histogram informative (the very signal attribute
  summaries compress) — this is what makes sparse labeling learnable;
- literal objects + a typed-literal sprinkle, exercising the parser paths;
- deterministic under seed; scales to AM-size (millions of triples).

Output is a ``*_complete.nt`` file consumable by the standard pipeline
(attribute summarizer included).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

ENTITY = "<http://synth.example.org/entity/e{}>"
RELATION = "<http://synth.example.org/relation/r{}>"
CLASS = "<http://synth.example.org/class/c{}>"
TYPE_PRED = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"


def generate_synthetic_nt(
    path: str,
    num_entities: int = 2000,
    num_relations: int = 12,
    num_classes: int = 4,
    avg_degree: float = 4.0,
    labeled_fraction: float = 0.1,
    literal_fraction: float = 0.05,
    homophily: float = 0.8,
    rel_signal: float = 0.7,
    seed: int = 0,
) -> str:
    """Write a synthetic ``*_complete.nt``; returns the path."""
    rng = np.random.default_rng(seed)
    latent = rng.integers(0, num_classes, num_entities)

    # group entities by latent class for homophilous target sampling
    by_class = [np.flatnonzero(latent == c) for c in range(num_classes)]
    num_edges = int(num_entities * avg_degree)

    src = rng.integers(0, num_entities, num_edges)
    # class-preferred relations: with prob rel_signal, the edge's relation is
    # drawn from the subject class's own stripe {c, c+C, c+2C, ...}
    rel = rng.integers(0, num_relations, num_edges)
    use_sig = rng.uniform(size=num_edges) < rel_signal
    stripe = latent[src] + num_classes * rng.integers(
        0, max(1, num_relations // num_classes), num_edges)
    rel = np.where(use_sig & (stripe < num_relations), stripe, rel)
    # with prob `homophily` the object shares the subject's latent class
    same = rng.uniform(size=num_edges) < homophily
    dst = np.empty(num_edges, np.int64)
    rand_dst = rng.integers(0, num_entities, num_edges)
    for c in range(num_classes):
        members = by_class[c]
        m = same & (latent[src] == c)
        if members.size and m.any():
            dst[m] = members[rng.integers(0, members.size, int(m.sum()))]
    dst[~same] = rand_dst[~same]

    is_lit = rng.uniform(size=num_edges) < literal_fraction
    labeled = rng.uniform(size=num_entities) < labeled_fraction

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for i in range(num_edges):
            s = ENTITY.format(src[i])
            p = RELATION.format(rel[i])
            if is_lit[i]:
                o = f'"lit {dst[i] % 97}"^^<http://www.w3.org/2001/XMLSchema#string>'
            else:
                o = ENTITY.format(dst[i])
            fh.write(f"{s} {p} {o} .\n")
        for e in np.flatnonzero(labeled):
            fh.write(f"{ENTITY.format(e)} {TYPE_PRED} {CLASS.format(latent[e])} .\n")
    return path


def ensure_synthetic_dataset(
    root: str,
    name: str = "SYNTH",
    num_entities: int = 2000,
    num_relations: int = 12,
    num_classes: int = 4,
    avg_degree: float = 4.0,
    seed: int = 0,
    with_attr_summaries: bool = True,
    labeled_fraction: float = 0.1,
) -> str:
    """Create ``{root}/{name}/{name}_complete.nt`` (+ attr summaries) if absent.

    Returns the dataset directory. Mirrors the reference's on-disk layout
    ``graphs/{ds}/{ds}_complete.nt`` + ``{ds}/attr/{sum,map}/`` (main.py:99-101).
    """
    ds_dir = os.path.join(root, name)
    org = os.path.join(ds_dir, f"{name}_complete.nt")
    if not os.path.exists(org):
        generate_synthetic_nt(
            org, num_entities=num_entities, num_relations=num_relations,
            num_classes=num_classes, avg_degree=avg_degree, seed=seed,
            labeled_fraction=labeled_fraction)
    if with_attr_summaries:
        sum_dir = os.path.join(ds_dir, "attr", "sum")
        map_dir = os.path.join(ds_dir, "attr", "map")
        if not os.path.isdir(sum_dir) or not os.listdir(sum_dir):
            from scaling_rgcn_training_tpu_torch.graphs.summarize.attribute import create_sum_map

            create_sum_map(org, sum_dir, map_dir, name)
    return ds_dir
