"""scaling_rgcn_training_tpu_torch — the PyTorch/CUDA port of
``scaling_rgcn_training_tpu`` for NVIDIA Hopper (H100).

R-GCN entity typing on RDF knowledge graphs, scaled through summary-graph
pre-training and embedding/weight transfer. The JAX package beside this
one is the reference; each module here keeps its counterpart's name:

- ``graphs``  — N-Triples parsing, vocab/label encoding, attribute
                summaries, synthetic data, dataset assembly, the device graph.
- ``ops``     — the per-relation graph conv (fused, edge and prematmul
                dataflows, relational attention), whose message passing
                runs through hand-written CUDA kernels (``csrc/``).
- ``models``  — the embedding model of the summation/baseline experiments.
- ``train``   — losses, metrics, optimizer, embedding transfer, trainer.
- ``utils``   — timing banners, config checks, results reports.
- ``main``    — the experiment CLI; ``profile_step`` — a step's profile.

Imports torch and numpy only: never jax, optax or sklearn, and nothing of
the JAX package.
"""
