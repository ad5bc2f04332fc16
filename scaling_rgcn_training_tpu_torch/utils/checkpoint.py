"""Checkpoint and resume of the port's training state.

Counterpart of the JAX package's ``utils/checkpoint.py``, in its format:

- ``save_checkpoint`` / ``load_checkpoint``: named arrays as ``{path}.npz``
  plus ``{path}.npz.meta.json`` (the epoch and whatever else the caller
  keeps there, e.g. the metric series). ``Trainer.fit`` stores the
  model's parameters in true node order, Adam's state per parameter name
  and the dropout generator's state (``train/trainer.py``), so a file
  written over S shards restores at any other shard count;
- ``save_transfer_state`` / ``load_transfer_state``: the summary
  pre-training's result, the trunk (``rgcn1``, ``rgcn2``) and the K summary
  embeddings, under the JAX package's keys ``trunk/<i>/weight``,
  ``trunk/<i>/root``, ``trunk/<i>/bias`` (``trunk/<i>/comp`` with a basis
  decomposition) and ``summary_embedding/<k>``: a file written by either
  package loads in the other.

One process writes each file once, to a temporary file that
``os.replace`` puts in place, so a crash leaves the previous file whole.
Across processes (a ``mesh`` of several, ``parallel/mesh.py``), the
counterpart of the JAX ``_leaf_to_host``: the node-sharded leaves
(``node_sharded``, this process's rows) are gathered across processes in
shard order, rank 0 writes, and the other ranks wait at a barrier, so the
file has the arrays' bits of the one the single-process run of the same
S shards writes; :func:`load_checkpoint` gives each process its rows of
those leaves (``put_global``'s rows), so a file moves between layouts.
The JAX package's Orbax backend (``RGCN_CKPT_BACKEND=orbax``) is not
ported. Files are read with ``allow_pickle=False``.
"""

from __future__ import annotations

import json
import os
from typing import (Any, Collection, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from scaling_rgcn_training_tpu_torch.parallel.mesh import (
    Mesh, gather_global, host_barrier, process_rows)

_LAYER_FIELDS = ("weight", "root", "bias", "comp")


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _as_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _write_npz(out: str, arrays: Mapping[str, Any]) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{k: _as_numpy(v) for k, v in arrays.items()})
    os.replace(tmp, out)


def _read_npz(src: str) -> Dict[str, np.ndarray]:
    with np.load(src, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def checkpoint_exists(path: str) -> bool:
    """Whether :func:`save_checkpoint` wrote a checkpoint at ``path``."""
    return os.path.exists(_npz_path(path))


def save_checkpoint(path: str, arrays: Mapping[str, Any], epoch: int = 0,
                    extra: Optional[Dict] = None, mesh: Optional[Mesh] = None,
                    node_sharded: Collection[str] = ()) -> str:
    """Write ``arrays`` (tensors or numpy arrays by name) to
    ``{path}.npz`` and ``{"epoch": epoch, **extra}`` to its
    ``.meta.json``; returns the ``.npz`` path. The epoch goes into both
    files, so :func:`load_checkpoint` can tell a matching pair. On a
    ``mesh`` of several processes every process calls it: the arrays named
    in ``node_sharded`` hold this process's rows and are gathered in shard
    order, rank 0 writes, and every process returns once the files are in
    place."""
    out = _npz_path(path)
    across = mesh is not None and mesh.multiprocess
    if across:
        arrays = {k: gather_global(v, mesh) if k in node_sharded else v
                  for k, v in arrays.items()}
    if not across or mesh.process_index == 0:
        _write_npz(out, {**arrays, "epoch": np.int64(epoch)})
        tmp = f"{out}.meta.json.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"epoch": int(epoch), **(extra or {})}, fh)
        os.replace(tmp, out + ".meta.json")
    if across:
        host_barrier(mesh)
    return out


def load_checkpoint(path: str, mesh: Optional[Mesh] = None,
                    node_sharded: Collection[str] = ()
                    ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """``(arrays, meta)`` of the checkpoint at ``path``; raises when the
    meta file belongs to another epoch than the arrays (a write cut
    between the two files). With a ``mesh``, the arrays named in
    ``node_sharded`` are cut to this process's rows."""
    src = _npz_path(path)
    arrays = _read_npz(src)
    epoch = int(arrays.pop("epoch"))
    with open(src + ".meta.json") as fh:
        meta = json.load(fh)
    if meta.get("epoch") != epoch:
        raise ValueError(f"{src} holds epoch {epoch}, its meta file "
                         f"epoch {meta.get('epoch')}")
    if mesh is not None:
        for k in node_sharded:
            arrays[k] = process_rows(arrays[k], mesh)
    return arrays, meta


def save_transfer_state(path: str, trunk: Sequence[Any],
                        summary_embeddings: Sequence[Any]) -> str:
    """Write the trunk layers (``RGCNLayer`` modules, or mappings with
    ``weight``, ``root``, ``bias`` and an optional ``comp``) and the
    summary embeddings under the JAX package's keys; returns the path."""
    arrays: Dict[str, Any] = {}
    for i, layer in enumerate(trunk):
        for name in _LAYER_FIELDS:
            value = layer.get(name) if isinstance(layer, Mapping) \
                else getattr(layer, name, None)
            if value is not None:
                arrays[f"trunk/{i}/{name}"] = value
    for k, emb in enumerate(summary_embeddings):
        arrays[f"summary_embedding/{k}"] = emb
    out = _npz_path(path)
    _write_npz(out, arrays)
    return out


def load_transfer_state(path: str
                        ) -> Tuple[List[Dict[str, np.ndarray]], List[np.ndarray]]:
    """``(trunk, embeddings)``: one dict of ``weight``, ``root``, ``bias``
    (and ``comp``) per trunk layer, in order, and the summary embeddings."""
    data = _read_npz(_npz_path(path))
    trunk = []
    while f"trunk/{len(trunk)}/weight" in data:
        i = len(trunk)
        trunk.append({name: data[f"trunk/{i}/{name}"] for name in _LAYER_FIELDS
                      if f"trunk/{i}/{name}" in data})
    embs = []
    while f"summary_embedding/{len(embs)}" in data:
        embs.append(data[f"summary_embedding/{len(embs)}"])
    return trunk, embs
