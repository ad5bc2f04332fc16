"""Benchmark of the PyTorch/CUDA port of the R-GCN trainer.

One run drives ``Trainer.fit`` of ``scaling_rgcn_training_tpu_torch`` for
one cell of ``BENCHMARK.json`` (a model configuration under a traffic mix,
each found by its name in a file of its own) and prints one JSON line:

    python3 -m rgcn_bench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Nothing here imports JAX or the JAX package; the plain reference
(``rgcn_bench/reference``) imports nothing of the port.
"""
