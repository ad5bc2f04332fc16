"""On-disk cache of the host-built edge plans, keyed by their content.

Counterpart of the JAX package's ``utils/plancache.py``. A plan is built
once per graph on the host (``ops/rgcn_conv.py`` ``build_rel_edges``,
``parallel/halo.py`` ``halo_partition_edges``, ``parallel/spmd.py``
``shard_rel_edges``); at the scale of AM that costs minutes a process. The
cache keeps the finished plan under a blake2b key of its kind, a format
``_VERSION``, its statics and the bytes of the raw edge arrays, so a
second start over the same graph loads it instead.

What a plan depends on, and so what the key holds:
- the raw ``(src, dst, type)`` arrays: a locality ``reorder`` relabels the
  nodes before the partition, so it reaches the key through them;
- the statics each plan function passes: node and slot counts, ``span``
  (whether ``RelEdges`` carries the span kernels' plan; ``num_src`` is
  the node count for every cached plan), the shard count and padding of
  a partition, whose kind (``"haloedges"`` or ``"shardededges"``) names
  it, and ``span_kernels.DW_CHUNK``, the chunk size of
  ``relation_chunks`` (the span plan's, #7's and the dW chunks), where
  the plan has chunks.
The JAX package's TPU knobs (``RGCN_SPAN_*``, ``RGCN_SEG_*``,
``RGCN_HALO_FPLAN*``) do not exist here, and ``RGCN_HALO_PALLAS_A2A``
picks the halo exchange at run time, so it changes no plan.

Format: one ``{kind}-{key}.npz`` per plan, every tensor and numpy array of
the plan's dataclasses as an array (a tensor that two fields share, as
``RelEdges`` shares the span plan's, is stored once and shared again on
load), and the dataclass tree with its ints as JSON in ``__tree__``. It
is read with ``allow_pickle=False``, and only the plan classes the
caller names are rebuilt from it, so loading runs no code from the file.
A file that others can write can still hand the trainer a wrong plan:
keep the cache directory private to the user or job, as with the JAX
package's pickles.

Plans are built and cached on the CPU; the callers move them to a device
at placement (``utils/plantree.py``), fresh and cached plans alike.
Writes go to a temporary file and ``os.replace``, so two processes
building one key at once leave one whole file. An unreadable entry is
rebuilt with a warning.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
import zipfile
from typing import Any, Callable, Dict, Iterable, Sequence

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.utils.tracing import span

# bump when a plan dataclass or its build changes
_VERSION = 1

_TREE = "__tree__"


def plan_key(kind: str, arrays: Iterable[np.ndarray], statics: tuple) -> str:
    """blake2b of the kind, ``_VERSION``, the statics and every array's
    dtype, shape and bytes."""
    h = hashlib.blake2b(digest_size=20)
    h.update(f"{kind}|v{_VERSION}|{statics!r}".encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"|{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _encode(obj: Any, arrays: Dict[str, np.ndarray], seen: Dict[int, str]):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        key = seen.get(id(obj))
        if key is None:
            key = seen[id(obj)] = f"a{len(arrays)}"
            arrays[key] = obj.detach().cpu().numpy() \
                if isinstance(obj, torch.Tensor) else obj
        return {"tensor" if isinstance(obj, torch.Tensor) else "array": key}
    if dataclasses.is_dataclass(obj):
        return {"class": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name), arrays, seen)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return {"tuple": [_encode(v, arrays, seen) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a plan holds no {type(obj).__name__}")


def _decode(node: Any, arrays, classes: Dict[str, type],
            tensors: Dict[str, torch.Tensor]):
    if not isinstance(node, dict):
        return node
    if "tensor" in node:
        key = node["tensor"]
        if key not in tensors:
            tensors[key] = torch.from_numpy(arrays[key])
        return tensors[key]
    if "array" in node:
        return arrays[node["array"]]
    if "tuple" in node:
        return tuple(_decode(v, arrays, classes, tensors)
                     for v in node["tuple"])
    cls = classes.get(node.get("class"))
    if cls is None:
        raise ValueError(f"not a plan class: {node.get('class')!r}")
    return cls(**{k: _decode(v, arrays, classes, tensors)
                  for k, v in node["fields"].items()})


def save_plan(path: str, plan: Any) -> None:
    """Write ``plan`` to ``path`` (``.npz``) through a temporary file."""
    arrays: Dict[str, np.ndarray] = {}
    tree = _encode(plan, arrays, {})
    arrays[_TREE] = np.frombuffer(json.dumps(tree).encode(), np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load_plan(path: str, classes: Sequence[type]) -> Any:
    """The plan ``save_plan`` wrote, its tensors on the CPU; ``classes``:
    the dataclasses it may hold (any other name raises ``ValueError``)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    tree = json.loads(arrays.pop(_TREE).tobytes().decode())
    return _decode(tree, arrays, {c.__name__: c for c in classes}, {})


def get_or_build(cache_dir, kind: str, arrays: Iterable[np.ndarray],
                 statics: tuple, build: Callable[[], Any],
                 classes: Sequence[type]) -> Any:
    """The cached plan of ``(kind, arrays, statics)``, or ``build()``'s,
    saved under ``cache_dir``; ``cache_dir`` None or empty: ``build()``
    alone. ``build`` returns the plan on the CPU; ``classes``: the plan
    dataclasses an entry may hold. The load or the save runs in the
    recorder's ``plan.cache`` span (``utils/tracing.py``)."""
    if not cache_dir:
        return build()
    arrays = [np.asarray(a) for a in arrays]
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir,
                        f"{kind}-{plan_key(kind, arrays, statics)}.npz")
    if os.path.exists(path):
        try:
            with span("plan.cache"):
                return load_plan(path, classes)
        except (OSError, EOFError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile) as e:
            warnings.warn(f"discarding unreadable plan cache entry {path}: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
    plan = build()
    with span("plan.cache"):
        save_plan(path, plan)
    return plan
