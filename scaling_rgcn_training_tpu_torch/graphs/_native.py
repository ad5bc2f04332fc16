"""ctypes binding of the native N-Triples parser (``native/ntgraph.cpp``).

Counterpart of the JAX package's ``graphs/_native.py``. The source is
compiled with ``g++`` at first use into ``build/torch_native/`` at the
root of the checkout, under a name that carries a hash of the source and
the flags (an edited source is rebuilt), through a temporary file and
``os.replace``, so processes building at once leave one whole library;
nothing is written into ``native/``. Nothing is built when the module is
imported.

Where ``g++`` is missing, :func:`get_lib` says so once on stderr and
returns None, and the callers parse in Python (the same graph: a host
path, no device code). A failed compile or load raises, on every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "ntgraph.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

# native parses in this process (chip_smoke.py checks that one ran)
PARSES = 0

_lock = threading.Lock()
_lib = None
_no_gxx = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libntgraph_{digest}.so"


def build() -> Optional[Path]:
    """Compile the library unless it is built; None without ``g++``."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        print("graphs/_native.py: no g++ found; parsing N-Triples in Python",
              file=sys.stderr)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded library, built at first use; None without ``g++``."""
    global _lib, _no_gxx
    with _lock:
        if _lib is not None or _no_gxx:
            return _lib
        path = build()
        if path is None:
            _no_gxx = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.ntg_parse.restype = ctypes.c_void_p
        lib.ntg_parse.argtypes = [ctypes.c_char_p]
        lib.ntg_free.argtypes = [ctypes.c_void_p]
        for fn in ("ntg_num_nodes", "ntg_num_relations", "ntg_num_edges_unique",
                   "ntg_num_edge_entries", "ntg_num_type_pairs"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("ntg_edge_src", "ntg_edge_dst", "ntg_edge_type"):
            getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_int32)
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("ntg_nodes_blob", "ntg_rels_blob", "ntg_types_blob"):
            getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_char)
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("ntg_nodes_offsets", "ntg_rels_offsets", "ntg_types_offsets"):
            getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_int64)
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _strings_from_blob(blob_ptr, offsets_ptr, count: int) -> List[str]:
    if count == 0:
        return []
    offs = np.ctypeslib.as_array(offsets_ptr, shape=(count + 1,))
    raw = ctypes.string_at(blob_ptr, int(offs[count]))
    return [raw[offs[i]:offs[i + 1]].decode("utf-8", errors="surrogateescape")
            for i in range(count)]


def parse_graph(path: str):
    """``(nodes, relations, edge_src, edge_dst, edge_type, num_unique_lines,
    type_pairs)`` of an ``.nt`` file, or None without the library.

    ``type_pairs``: the ``(subject, object)`` of every rdf:type triple, in
    file order, for the class vocabulary and the node labels."""
    global PARSES
    lib = get_lib()
    if lib is None:
        return None
    h = lib.ntg_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        n_nodes = lib.ntg_num_nodes(h)
        n_rels = lib.ntg_num_relations(h)
        n_uniq = lib.ntg_num_edges_unique(h)
        n_entries = lib.ntg_num_edge_entries(h)
        n_types = lib.ntg_num_type_pairs(h)
        nodes = _strings_from_blob(lib.ntg_nodes_blob(h),
                                   lib.ntg_nodes_offsets(h), n_nodes)
        rels = _strings_from_blob(lib.ntg_rels_blob(h),
                                  lib.ntg_rels_offsets(h), n_rels)
        tflat = _strings_from_blob(lib.ntg_types_blob(h),
                                   lib.ntg_types_offsets(h), 2 * n_types)
        type_pairs = list(zip(tflat[0::2], tflat[1::2]))
        if n_entries:
            src, dst, typ = (np.ctypeslib.as_array(
                fn(h), shape=(n_entries,)).copy() for fn in
                (lib.ntg_edge_src, lib.ntg_edge_dst, lib.ntg_edge_type))
        else:
            src = dst = typ = np.zeros(0, np.int32)
    finally:
        lib.ntg_free(h)
    PARSES += 1
    return nodes, rels, src, dst, typ, int(n_uniq), type_pairs
