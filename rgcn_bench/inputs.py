"""Everything a run draws from its seed, handed alike to the program and to
the reference: the triples (the traffic mix's generator), the labelled
rows and their classes, the initial parameters (drawn on the device by a
``torch.Generator`` there, one call a tensor) and the trainer's seed.

Each draw has a stream of its own under ``numpy.random.SeedSequence``, so
any whole seed (also past 32 bits) gives the same inputs every time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rgcn_bench import spec
from rgcn_bench.reference import rgcn

# streams of the seed (the graph's is the generator's own, 1)
_LABELS, _WEIGHTS, _TRAINER = 2, 3, 4


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``."""
    state = np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


@dataclasses.dataclass
class Inputs:
    triples: Tuple[np.ndarray, np.ndarray, np.ndarray]
    labels: Dict[str, np.ndarray]
    trainer_seed: int
    weights_seed: int


def labels(config: Dict[str, Any], seed: int) -> Dict[str, np.ndarray]:
    """The labelled entities, drawn without replacement, the first
    ``num_train`` for training and the next ``num_val`` for validation;
    row ``i`` has class ``i % num_classes``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, _LABELS]))
    n_train, n_val = config["num_train"], config["num_val"]
    rows = rng.choice(config["num_entities"], n_train + n_val, replace=False)
    classes = np.arange(n_train + n_val) % config["num_classes"]
    return {"x_train": rows[:n_train].astype(np.int64),
            "y_train": classes[:n_train].astype(np.int64),
            "x_val": rows[n_train:].astype(np.int64),
            "y_val": classes[n_train:].astype(np.int64)}


def make(cell: spec.Cell, seed: int) -> Inputs:
    gen = spec.traffic_generator(cell.traffic)
    return Inputs(triples=gen.triples(cell.traffic, cell.config, seed),
                  labels=labels(cell.config, seed),
                  trainer_seed=stream_seed(seed, _TRAINER),
                  weights_seed=stream_seed(seed, _WEIGHTS))


def params(config: Dict[str, Any], inputs: Inputs,
           device) -> Dict[str, torch.Tensor]:
    """The initial parameters, by the program's parameter names, drawn on
    ``device`` (the same values every call)."""
    gen = torch.Generator(device=device).manual_seed(inputs.weights_seed)
    return rgcn.head_module(config).init_params(config, gen, device)


def program_edges(triples) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(src, dst, type)`` as the CLI's ``Graph`` lays out the triples:
    each triple's forward edge (type ``2r``) followed by its inverse
    (``2r + 1``)."""
    subj, rel, obj = triples
    out = [np.empty(2 * subj.size, np.int32) for _ in range(3)]
    for a, (fwd, inv) in zip(out, ((subj, obj), (obj, subj),
                                   (2 * rel, 2 * rel + 1))):
        a[0::2], a[1::2] = fwd, inv
    return out[0], out[1], out[2]


def dropout_masks(config: Dict[str, Any], inputs: Inputs, device,
                  skip: int = 0
                  ) -> Optional[Callable[[Sequence[int]], torch.Tensor]]:
    """The keep masks of a fit's training forwards, one draw a step, from
    the step after the first ``skip``, for a head with dropout: a fit
    draws one seed from the trainer's generator (seeded with the trainer's
    seed; the fit's first draw) for a generator on the device, whose
    ``rand >= p`` keeps an attention weight."""
    p = config.get("dropout", 0.0)
    if not p:
        return None
    first = torch.randint(0, 2**62, (1,), generator=torch.Generator(
        ).manual_seed(inputs.trainer_seed))
    gen = torch.Generator(device=device).manual_seed(int(first))
    draw = lambda shape: torch.rand(shape, generator=gen, device=device) >= p
    shape = rgcn.head_module(config).mask_shape(config)
    for _ in range(skip):
        draw(shape)
    return draw
