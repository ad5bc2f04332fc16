"""Build and load the port's CUDA kernels, and count their launches.

Each source ``csrc/<name>.cu`` of ``SOURCES`` (the model's kernels, and
``step_marks``, the train step's device stamps) has a plain C interface
and is compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` (the file name carries a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
is rebuilt), then loaded with ``ctypes``.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for all of them; a failed build raises. A source may also be built
with one preprocessor ``define`` into a library of its own (the
microbench's instrumented kernel #8, ``BWD_TC_PHASES``). Nothing is built when a
module is imported: the first kernel launch builds what it needs.

``LAUNCHES`` counts kernel launches by wrapper name: a wrapper adds one
where it launches its CUDA kernel, and nowhere else (the plain CPU
versions add nothing), so a run can show that it went through a kernel.
The step marks of ``csrc/step_marks.cu`` (``utils/tracing.py`` ``mark``)
are instrumentation, not the model's work, and are not counted.

Each ``nvcc`` run lies in a ``kernel.build`` span of the recorder
(``utils/tracing.py``, with the sources it compiles) and adds to its
counter ``kernel_builds``; each ``ctypes.CDLL`` in a ``kernel.load`` span.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

from scaling_rgcn_training_tpu_torch.utils import tracing

SOURCES = ("span_fwd_tc", "span_bwd_tc", "span_kernels", "segment_kernels",
           "grouped_kernels", "halo_kernels", "bwd_variants",
           "attention_kernels", "basis_kernels", "step_marks")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "span_forward": 0, "span_forward_rows": 0, "span_backward": 0,
    "span_backward_half": 0, "span_backward_rows": 0, "segment_sum": 0,
    "segment_sum_rows": 0,
    "grouped_matmul": 0, "grouped_matmul_simt": 0, "grouped_drhs": 0,
    "grouped_drhs_simt": 0,
    "halo_exchange": 0, "fused_halo_aggregate": 0,
    "fused_halo_aggregate_rows": 0,
    "span_backward_variant": 0, "span_backward_variant_simt": 0,
    "mha_forward": 0, "mha_backward": 0, "basis_forward": 0,
    "basis_backward": 0}

# ptxas report (registers, shared memory, spills) of each source built by
# this process
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[tuple, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(define: str):
    return NVCC_FLAGS + ((f"-D{define}",) if define else ())


def library_path(name: str, define: str = "") -> Path:
    text = b"".join(p.read_bytes() for p in
                    [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(_flags(define)).encode()
                            ).hexdigest()[:16]
    tag = f"_{define.lower()}" if define else ""
    return BUILD_DIR / f"lib{name}{tag}_{digest}.so"


def build(names: Iterable[str] = SOURCES, define: str = "") -> Dict[str, Path]:
    """Compile the named sources that are not built yet (with ``define``,
    if given), one ``nvcc`` each, in parallel; return every library's
    path. Raises when a build fails."""
    paths = {n: library_path(n, define) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    with tracing.span("kernel.build", sources=sorted(todo), define=define):
        tracing.count("kernel_builds", len(todo))
        for n, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *_flags(define), "-o", str(tmp),
                 str(_CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {n}.cu:\n{out}{err}")
                continue
            os.replace(tmp, todo[n])
            build_logs[f"{n}:{define}" if define else n] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, declare: Callable[[ctypes.CDLL], None],
         define: str = "") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``define``, if
    given), built at first use; ``declare`` sets its functions'
    ``argtypes`` and ``restype``."""
    with _lock:
        lib = _libs.get((name, define))
        if lib is None:
            path = build([name], define)[name]
            with tracing.span("kernel.load", source=name, define=define):
                lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[(name, define)] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")


def on_card(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises otherwise."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError("kernels need every tensor on one CUDA device (or "
                         f"all on the CPU), got {sorted(map(str, devices))}")
    return True
