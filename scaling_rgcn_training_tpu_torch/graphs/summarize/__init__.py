"""Summary-graph construction tooling (reference graphs/create*.py).

- attribute:   murmur-hash attribute summaries (createAttributeSum.py)
- dummy:       uniform-random control summaries (createDummySum.py)
- bisim:       FLUID (k)-forward-bisimulation CSV -> map converter
               (createBisimMapping.py)
"""

from scaling_rgcn_training_tpu_torch.graphs.summarize.attribute import create_sum_map
from scaling_rgcn_training_tpu_torch.graphs.summarize.bisim import create_bisim_map_nt
from scaling_rgcn_training_tpu_torch.graphs.summarize.dummy import create_dummy_sum_map
from scaling_rgcn_training_tpu_torch.graphs.summarize.murmur import hash128

__all__ = ["create_sum_map", "create_bisim_map_nt", "create_dummy_sum_map",
           "hash128"]
