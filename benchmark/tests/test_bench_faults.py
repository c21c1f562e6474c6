"""A run with the timed path broken underneath must come out not
correct: for each fault a cell can have, the tiny CPU cell (float32
compute, where the sound run reads far below the limits) with the fault
planted in the program."""

import importlib

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import SAMPLE, SERVE, TRAIN


def drive(name, **kw):
    torch.set_num_threads(2)
    r = tiny.cell(name, **kw)
    importlib.import_module("benchmark.drivers." + r.spec["driver"]).run(r)
    return r


def _unchanged_structure_step(monkeypatch):
    """A reverse step that returns its state unchanged."""
    from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion

    def step(self, denoise_fn, st, *, ddim, eta=1.0):
        st.i += 1

    monkeypatch.setattr(GaussianAngleDiffusion, "reverse_step", step)


def _half_batch_structure_step(monkeypatch):
    """A reverse step that leaves half of the batch (every other row: the
    live slots fill a batch from its first row) out."""
    from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion

    original = GaussianAngleDiffusion.reverse_step

    def step(self, denoise_fn, st, *, ddim, eta=1.0):
        keep = st.x.clone()
        original(self, denoise_fn, st, ddim=ddim, eta=eta)
        st.x[1::2] = keep[1::2]

    monkeypatch.setattr(GaussianAngleDiffusion, "reverse_step", step)


def _altered_structure_answer(monkeypatch):
    """The sampled angles altered where they are produced: the last
    reverse step's output moved by 0.05 rad."""
    from e3diff_tpu_torch.diffusion import gaussian

    original = gaussian.GaussianAngleDiffusion.p_step

    def p_step(self, x_t, eps_hat, t, z):
        out = original(self, x_t, eps_hat, t, z)
        return out + 0.05 * (t == 0).to(out.dtype)[:, None, None]

    monkeypatch.setattr(gaussian.GaussianAngleDiffusion, "p_step", p_step)


def _altered_token(monkeypatch):
    """A served sequence altered where the engine produces it."""
    from e3diff_tpu_torch.serving import engine

    original = engine.DesignEngine._results

    def results(self, *a, **k):
        out = original(self, *a, **k)
        for r in out:
            r.sequence = ("W" if r.sequence[0] != "W" else "A") + r.sequence[1:]
        return out

    monkeypatch.setattr(engine.DesignEngine, "_results", results)


def _half_batch_sequence_step(monkeypatch):
    from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion

    original = D3PMDiffusion.reverse_step

    def step(self, denoise_fn, st, *, diverse):
        keep = st.x.clone()
        original(self, denoise_fn, st, diverse=diverse)
        st.x[1::2] = keep[1::2]

    monkeypatch.setattr(D3PMDiffusion, "reverse_step", step)


@pytest.mark.parametrize("fault", [
    _unchanged_structure_step, _half_batch_structure_step,
    _altered_structure_answer])
def test_sample_cell_faults(monkeypatch, fault):
    fault(monkeypatch)
    r = drive("structure-146m.sample-ddpm1000-b64", **SAMPLE)
    assert not r.correct(), r.readings


@pytest.mark.parametrize("fault", [
    _unchanged_structure_step, _half_batch_sequence_step, _altered_token])
def test_serve_cell_faults(monkeypatch, fault):
    fault(monkeypatch)
    r = drive("design-146m-61m.serve-steady", **SERVE)
    assert not r.correct(), r.readings


def _unchanged_train_state(monkeypatch):
    """An optimizer step that returns the state unchanged."""
    from e3diff_tpu_torch.training import optim

    def step(self, grads):
        from e3diff_tpu_torch.training.optim import global_norm

        self.count.add_(1)
        return global_norm(grads)

    monkeypatch.setattr(optim.AdamW, "step", step)


def _half_train_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from e3diff_tpu_torch.training.structure import StructureTrainer

    original = StructureTrainer._loss

    def loss(self, batch):
        half = batch["ligand_angles"].shape[0] // 2
        return original(self, {k: v[:half] for k, v in batch.items()})

    monkeypatch.setattr(StructureTrainer, "_loss", loss)


@pytest.mark.parametrize("fault", [_unchanged_train_state,
                                   _half_train_batch])
def test_train_cell_faults(monkeypatch, fault):
    fault(monkeypatch)
    r = drive("structure-146m.train-b64", **TRAIN)
    assert not r.correct(), r.readings


def test_sound_tiny_runs_are_correct():
    for name, kw in (("structure-146m.sample-ddpm1000-b64", SAMPLE),
                     ("structure-146m.train-b64", TRAIN)):
        r = drive(name, **kw)
        assert r.correct(), r.readings
