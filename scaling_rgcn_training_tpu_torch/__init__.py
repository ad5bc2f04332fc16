"""scaling_rgcn_training_tpu_torch — the PyTorch/CUDA port of
``scaling_rgcn_training_tpu`` for NVIDIA Hopper (H100).

R-GCN entity typing on RDF knowledge graphs, scaled through summary-graph
pre-training and embedding/weight transfer. The JAX package beside this
one is the reference; each module here keeps its counterpart's name:

- ``graphs``  — N-Triples parsing, vocab/label encoding, attribute
                summaries, synthetic data, dataset assembly, the device graph.
- ``ops``     — the per-relation graph conv, whose message passing runs
                through hand-written CUDA kernels (``csrc/``).
- ``models``  — the embedding model of the summation/baseline experiments.
- ``train``   — losses, metrics, optimizer, embedding transfer, trainer.
- ``main``    — the experiment CLI.

Imports torch and numpy only: never jax, optax or sklearn.
"""
