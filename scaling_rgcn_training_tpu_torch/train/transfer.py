"""Summary -> full-graph embedding transfer, summation trick.

Reference model/embeddingTricks.py:8-25,45-49: per summary graph, an
``[N_org, d]`` tensor drawn U[0, 1) (``torch.rand``) whose row
``idx(orgNode)`` is overwritten with the trained embedding row of its
summary node; the per-summary tensors are summed. The concat and stack
tricks of the MLP and attention heads are not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
from scaling_rgcn_training_tpu_torch.graphs.processing import mapping_index_arrays


def build_transfer_tensors(org_graph: Graph, sum_graphs: List[Graph],
                           emb_dim: int, gen: torch.Generator) -> List[torch.Tensor]:
    """One ``[N_org, d]`` tensor per summary graph (on the CPU)."""
    tensors = []
    for sg in sum_graphs:
        if sg.embedding is None:
            raise ValueError(f"summary graph {sg.name} has no trained "
                             "embedding; run train_summaries first")
        base = torch.rand((org_graph.num_nodes, emb_dim), generator=gen)
        org_idx, sum_idx = mapping_index_arrays(org_graph, sg)
        emb = torch.as_tensor(sg.embedding, dtype=torch.float32)
        base[torch.as_tensor(org_idx, dtype=torch.int64)] = \
            emb[torch.as_tensor(sum_idx, dtype=torch.int64)]
        tensors.append(base)
    return tensors


def sum_embeddings(org_graph: Graph, sum_graphs: List[Graph], emb_dim: int,
                   gen: torch.Generator) -> torch.Tensor:
    """[N, d] — elementwise sum over summaries (embeddingTricks.py:45-49)."""
    return torch.stack(build_transfer_tensors(
        org_graph, sum_graphs, emb_dim, gen)).sum(0)


EMBEDDING_TRICKS = {
    "summation": sum_embeddings,
}
