"""The port's ``bench_scaling.py`` against the JAX package's
``scripts/bench_scaling.py``, on the CPU (virtual CPU shards, the
kernels' plain versions) at N 3,000, E 30,000, 5 relations (11 slots),
64 communities, 64 -> 16 -> 8.

- ``sbm_edges`` (and the relation draw after it) equals the script's
  draws at ``:59-83``, recomputed here from ``default_rng(0)``.
- ``halo_rows_per_shard`` at k = 2 and 4 equals ``H (k - 1)`` of the JAX
  package's ``locality_reorder`` + ``halo_partition_edges`` on the same
  draws (with and without the reorder), an integer count.
- The k = 2 and 4 losses (every step, library exchange, #6's and #7's
  plain versions) equal k = 1's within 1e-5 relative, float32: every
  count trains the same model, only the order of the sums differs.
- Each line carries the script's keys (``:173-181``); virtual shards and
  the CPU read ``measures_hardware_scaling: false``.
"""

import json

import numpy as np
import pytest
import torch

from scaling_rgcn_training_tpu.parallel import halo as jhalo
from scaling_rgcn_training_tpu.parallel import reorder as jreorder
from scaling_rgcn_training_tpu_torch import bench_scaling as bsc
from scaling_rgcn_training_tpu_torch.parallel.halo import EXCHANGE_ENV

SMALL = {"BENCH_NODES": "3000", "BENCH_EDGES": "30000", "BENCH_RELS": "5",
         "BENCH_DIM": "64", "BENCH_HIDDEN": "16", "BENCH_INNER": "1",
         "BENCH_CALLS": "2", "BENCH_DEVICE": "cpu"}
JAX_KEYS = ("devices", "ms_per_step", "edges_per_s", "efficiency",
            "throughput_retention", "hardware", "halo_rows_per_shard",
            "measures_hardware_scaling")


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setenv(name, value)
    for name in ("BENCH_GRAPH", "BENCH_COMMUNITIES", "BENCH_P_IN",
                 "BENCH_REORDER", "BENCH_COMPUTE_DTYPE", EXCHANGE_ENV):
        monkeypatch.delenv(name, raising=False)
    return bsc.knobs()


def _jax_draws(n, e, r, n_comm=64, p_in=0.9):
    """``scripts/bench_scaling.py:59-84``, line for line."""
    rng = np.random.default_rng(0)
    comm = rng.integers(0, n_comm, n)
    order_c = np.argsort(comm, kind="stable")
    csize = np.bincount(comm, minlength=n_comm)
    coff = np.concatenate([[0], np.cumsum(csize)])
    intra = rng.random(e) < p_in
    ei = int(intra.sum())
    ci_ = rng.integers(0, n_comm, ei)
    pick = lambda: order_c[coff[ci_]
                           + (rng.random(ei) * csize[ci_]).astype(np.int64)]
    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    src[intra], dst[intra] = pick(), pick()
    m = e - ei
    src[~intra] = rng.integers(0, n, m)
    dst[~intra] = rng.integers(0, n, m)
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)
    return src, dst, typ, 2 * r + 1


@pytest.mark.parametrize("n,e,n_comm,p_in", [(3000, 30000, 64, 0.9),
                                             (500, 7000, 7, 0.5)])
def test_sbm_edges_equal_the_jax_draws(n, e, n_comm, p_in):
    rng = np.random.default_rng(0)
    src, dst = bsc.sbm_edges(rng, n, e, n_comm, p_in)
    typ = rng.integers(0, 10, e).astype(np.int32)
    ref = _jax_draws(n, e, 5, n_comm, p_in)
    for a, b in zip((src, dst, typ), ref):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_graph_equals_the_jax_draws(small, monkeypatch):
    for a, b in zip(bsc.graph(small), _jax_draws(3000, 30000, 5)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("BENCH_GRAPH", "random")
    src, dst, typ, slots = bsc.graph(bsc.knobs())
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(src, rng.integers(0, 3000, 30000))
    np.testing.assert_array_equal(dst, rng.integers(0, 3000, 30000))
    np.testing.assert_array_equal(typ, rng.integers(0, 10, 30000))


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_halo_rows_equal_the_jax_partition(small, shards, reorder):
    src, dst, typ, slots = _jax_draws(3000, 30000, 5)
    jsrc, jdst = src, dst
    if reorder:
        perm = jreorder.locality_reorder(src, dst, 3000, num_shards=shards)
        jsrc, jdst = perm[src], perm[dst]
    ref = jhalo.halo_partition_edges(jsrc, jdst, typ, 3000, slots, shards,
                                     pad_to_multiple=512)
    perm, got = bsc.partition(src, dst, typ, 3000, slots, shards, reorder)
    if reorder:
        np.testing.assert_array_equal(
            perm, jreorder.locality_reorder(src, dst, 3000,
                                            num_shards=shards))
    assert got.halo == int(ref.halo)
    assert got.n_per == int(ref.n_per)


@pytest.mark.parametrize("exchange", [None, "1", "fused"])
def test_shard_losses_match_one_shard(small, monkeypatch, capsys, exchange):
    if exchange is not None:
        monkeypatch.setenv(EXCHANGE_ENV, exchange)
    recs = bsc.main(["--max-shards", "4"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines == json.loads(json.dumps(recs))
    assert [r["devices"] for r in recs] == [1, 2, 4]
    steps = 2 * 1 + 2 * 1
    for rec in recs:
        assert set(JAX_KEYS) <= set(rec)
        assert rec["hardware"] == "cpu"
        assert rec["measures_hardware_scaling"] is False
        assert rec["cards"] == 0 and rec["peak_mib"] is None
        # the CPU has no cards: nothing is copied between two of them
        assert rec["peak_mib_per_card"] is None
        assert rec["cross_card_mb_per_step"] == 0
        assert rec["exchange"] == {None: "library", "1": "#6",
                                   "fused": "#7"}[exchange]
        assert len(rec["losses"]) == steps
        assert all(np.isfinite(v) for k, v in rec.items()
                   if isinstance(v, float))
        np.testing.assert_allclose(rec["losses"], recs[0]["losses"],
                                   rtol=1e-5, atol=0)
    assert recs[0]["halo_rows_per_shard"] == 0
    assert recs[0]["efficiency"] == recs[0]["throughput_retention"] == 1.0
    for rec in recs[1:]:
        assert rec["halo_rows_per_shard"] > 0
        assert rec["efficiency"] == pytest.approx(
            rec["edges_per_s"] / (recs[0]["edges_per_s"] * rec["devices"]))


def test_partitions_are_kept_for_a_second_call(small, monkeypatch, capsys):
    """``main(partitions=...)`` reuses each count's reorder and partition,
    and gives the same losses."""
    monkeypatch.setattr(bsc, "partition", _counting(bsc.partition))
    kept = {}
    first = bsc.main(["--max-shards", "2"], partitions=kept)
    assert sorted(kept) == [1, 2] and bsc.partition.calls == 2
    again = bsc.main(["--max-shards", "2"], partitions=kept)
    assert bsc.partition.calls == 2
    assert [r["losses"] for r in again] == [r["losses"] for r in first]


def test_bfloat16_streams_and_defaults(small, monkeypatch):
    monkeypatch.setenv("BENCH_COMPUTE_DTYPE", "bf16")
    monkeypatch.setenv("BENCH_REORDER", "0")
    k = bsc.knobs()
    assert k["compute_dtype"] is torch.bfloat16 and not k["reorder"]
    rec = bsc.main([])[0]
    assert rec["devices"] == 1 and rec["compute_dtype"] == "bfloat16"
    for name in (*SMALL, "BENCH_COMPUTE_DTYPE", "BENCH_REORDER"):
        monkeypatch.delenv(name)
    k = bsc.knobs()
    assert (k["nodes"], k["edges"], k["rels"], k["dim"], k["hidden"],
            k["inner"], k["calls"], k["graph"], k["communities"], k["p_in"],
            k["reorder"], k["compute_dtype"], k["device"]) == \
        (100_000, 2_000_000, 20, 64, 16, 5, 3, "sbm", 64, 0.9, True, None,
         "cuda")


def _counting(fn):
    def wrapped(*args, **kw):
        wrapped.calls += 1
        return fn(*args, **kw)
    wrapped.calls = 0
    return wrapped


def test_trace_writes_each_counts_steps(small, tmp_path):
    """``--trace DIR``: a Chrome trace of each count's traced steps under
    ``DIR/k<count>`` with the annotated region; no card here, so no
    device events and empty busy maps (null without ``--trace``)."""
    recs = bsc.main(["--max-shards", "2", "--trace", str(tmp_path)])
    for rec in recs:
        files = list((tmp_path / f"k{rec['devices']}").glob("*.json"))
        assert len(files) == 1
        assert "bench_scaling_step" in files[0].read_text()
        assert rec["device_busy_ms_per_step"] == {}
        assert len(rec["losses"]) == 4
    assert bsc.main(["--max-shards", "1"])[0]["device_busy_ms_per_step"] \
        is None


def test_device_busy_sums_each_cards_device_events():
    """Device events summed by card, annotations and host events left
    out, per step."""
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    span = lambda us: NS(elapsed_us=lambda: us)
    events = [NS(device_type=cuda, device_index=0, time_range=span(3000)),
              NS(device_type=cuda, device_index=1, time_range=span(500)),
              NS(device_type=cuda, device_index=0, time_range=span(1000)),
              NS(device_type=cuda, device_index=0, time_range=span(9000),
                 is_user_annotation=True),
              NS(device_type=cpu, device_index=-1, time_range=span(7000))]
    prof = NS(events=lambda: events)
    assert bsc.device_busy_ms(prof, 2) == {"0": 2.0, "1": 0.25}
