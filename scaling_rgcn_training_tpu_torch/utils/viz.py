"""Embedding visualization for ``-e_viz`` (reference helpers/vizEmb.py:9-35).

Saves the embedding the summation head starts from, ``[N, d]`` in true
node order: the transferred summed summary embeddings (the original
reference's ``modelTrainer.py:98-100``), as ``.npy``; then, when
matplotlib and scikit-learn import, a t-SNE scatter (``init='pca'``) as
PDF. The JAX package saves an embedding drawn anew from
``jax.random.key(0)`` instead of the one that trained; the rows every
summary maps agree, the U[0, 1) rows of the others differ.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def save_and_viz_embedding(configs: Dict[str, Any], embedding) -> str:
    """Write ``{results_root}/embeddings/{dataset}_{sum}_embedding.npy``
    (and its PDF where the imports allow); returns the ``.npy`` path."""
    out_dir = os.path.join(configs.get("results_root") or "./results",
                           "embeddings")
    os.makedirs(out_dir, exist_ok=True)
    emb = np.asarray(embedding, np.float32)
    base = f'{configs["dataset"]}_{configs["sum"]}_embedding'
    path = os.path.join(out_dir, base + ".npy")
    np.save(path, emb)
    viz_embedding(emb, configs["dataset"], configs["sum"], out_dir)
    return path


def viz_embedding(embedding: np.ndarray, dataset: str, sum_name: str,
                  out_dir: str) -> str:
    """The t-SNE PDF's path, or "" when matplotlib or scikit-learn is
    missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except ImportError:
        return ""
    trans = TSNE(init="pca").fit_transform(embedding)
    x, y = trans[:, 0], trans[:, 1]
    sum_type = {"attr": "Attribute", "bisim": "(k)-f. bisim."}.get(
        sum_name, sum_name)
    plt.figure()
    plt.scatter(x, y, c=x - y, cmap="viridis_r", s=0.8)
    plt.title(f"t-SNE transformed entity embedding ({dataset} {sum_type} "
              "summaries)")
    out = os.path.join(out_dir, f"{dataset}_{sum_name}_embedding.pdf")
    plt.savefig(out, format="pdf")
    plt.close()
    return out
