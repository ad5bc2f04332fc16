"""The comparison fails what it must: the control (the reference in
TF32) against each cell's limits, and a whole run on the CPU with the
program broken underneath (the harness's look for a card skipped)."""

import time

import pytest
import torch

from rgcn_bench import compare, harness, inputs
from rgcn_bench.reference import rgcn
from rgcn_bench.tests.tiny import CELLS, tiny_cell
from scaling_rgcn_training_tpu_torch.models import heads
from scaling_rgcn_training_tpu_torch.train import losses, trainer


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    config = cell.config
    for seed in (1, 2, 3):
        inp = inputs.make(cell, seed)
        params0 = inputs.params(config, inp, "cpu")
        edges = rgcn.build_edges(*inp.triples, config["num_entities"], "cpu")
        fit = lambda precision: rgcn.fit(
            config, edges, inp.labels, params0, 1,
            inputs.dropout_masks(config, inp, "cpu"), precision)
        values = compare.numbers(config, fit("tf32"), fit("float64"),
                                 params0, inp.labels["y_val"])
        over = [k for k in compare.STEP_NUMBERS
                if not values[k] <= cell.limits[k]]
        assert over, (values, cell.limits)


def _run(name):
    return harness.run_cell(tiny_cell(name), 7, 0.3, False, "cpu",
                            time.perf_counter())


def _state_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *a, **k):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g["params"]]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g["params"]), before):
                p.copy_(b)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)


def _half_batch(monkeypatch):
    ce = losses.ce_loss
    monkeypatch.setattr(losses, "ce_loss", lambda z, t: ce(
        z[: z.shape[0] // 2], t[: t.shape[0] // 2]))


def _logit_altered(monkeypatch):
    model_forward = heads.EmbModel.forward

    def altered(self, *a, **k):
        out = model_forward(self, *a, **k).clone()
        out[:, 0] += 1e-2
        return out
    monkeypatch.setattr(heads.EmbModel, "forward", altered)


def _answer_altered(monkeypatch):
    evaluate = trainer.evaluate

    def altered(logits, x, y, activation):
        acc, f1_w, f1_m = evaluate(logits, x, y, activation)
        return acc + 1.0 / x.shape[0], f1_w, f1_m
    monkeypatch.setattr(trainer, "evaluate", altered)


def _count_fixed_at_capture(monkeypatch):
    """Adam's update count stays at the third step's from the fourth on,
    as a scalar fixed when the step is captured would (the eager route
    here; the third step is the captured one on a card)."""
    step = torch.optim.Adam.step

    def fixed(self, *a, **k):
        for state in self.state.values():
            if float(state["step"]) >= 3:
                state["step"].fill_(2)
        return step(self, *a, **k)
    monkeypatch.setattr(torch.optim.Adam, "step", fixed)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "logit_altered": _logit_altered, "answer_altered": _answer_altered,
          "count_fixed_at_capture": _count_fixed_at_capture}


def test_sound_run_is_correct():
    result = _run("am_baseline_uniform")
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"step_ms", "step_p95_ms",
                                      "peak_reserved_mib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_program_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run("am_baseline_uniform")
    assert not result["correct"], result["checks"]


def test_only_the_replay_sees_a_value_fixed_at_capture(monkeypatch):
    _count_fixed_at_capture(monkeypatch)
    checks = _run("am_baseline_uniform")["checks"]
    over = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert over and all(k.startswith(compare.REPLAY) for k in over), checks
