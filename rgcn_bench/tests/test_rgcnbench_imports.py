"""No run loads JAX or the JAX package (top-level names compared whole),
and the reference loads nothing of the port."""

import subprocess
import sys

from rgcn_bench import run, spec

_REFERENCE = """
import sys
import rgcn_bench.reference.rgcn, rgcn_bench.reference.head_baseline
import rgcn_bench.reference.head_attention, rgcn_bench.reference.trunk_dense
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"scaling_rgcn_training_tpu_torch",
                    "scaling_rgcn_training_tpu", "jax", "jaxlib", "optax",
                    "flax"}))
"""

_RUN = """
import time
from rgcn_bench import harness, run
from rgcn_bench.tests.tiny import tiny_cell
r = harness.run_cell(tiny_cell("am_attention_uniform"), 3, 0.2, True, "cpu",
                     time.perf_counter())
print(r["correct"], run.forbidden_modules())
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_port():
    assert _python(_REFERENCE) == "[]"


def test_a_run_loads_no_jax():
    assert _python(_RUN) == "True []"


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "scaling_rgcn_training_tpu_torch_x",
                        sys)
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in run.forbidden_modules()
    assert "scaling_rgcn_training_tpu_torch_x" not in before
