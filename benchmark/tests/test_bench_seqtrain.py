"""The sequence train cell on the CPU at tiny widths in float32 compute:
the sound run follows the reference to rounding and is correct; each
fault planted in the program's D3PM step, and the int8 control, reads
not correct; and the FLOP count of benchmark/flops_seq.py equals the
GEMM operations the program's forward runs."""

import importlib

import pytest
import torch

from benchmark import flops_seq
from benchmark.tests import tiny
from benchmark.tests.test_bench_faults import _unchanged_train_state

CELL = "sequence-61m.train-b64"
SEQTRAIN = dict(mix={"batch_size": 4, "pool": 16},
                config={"compute_dtype": "f32"}, seconds=0.5)


def drive(**kw):
    torch.set_num_threads(2)
    r = tiny.cell(CELL, **{**SEQTRAIN, **kw})
    importlib.import_module("benchmark.drivers." + r.spec["driver"]).run(r)
    return r


def _uniform_transition(monkeypatch):
    """The uniform transition in place of BLOSUM."""
    from e3diff_tpu_torch.utils import builders

    original = builders.build_sequence_diffusion

    def build(cfg, transition="blosum", *, device):
        return original(cfg, "uniform", device=device)

    monkeypatch.setattr(builders, "build_sequence_diffusion", build)


def _t_exclusive(monkeypatch):
    """t drawn from {0..T-1}, where the source draws from {0..T} (Q10)."""
    from e3diff_tpu_torch.training.sequence import SequenceTrainer

    original = SequenceTrainer._loss

    def loss(self, batch):
        if "t_int" not in batch:
            lig = batch["ligand_seq"]
            batch = {**batch, "t_int": torch.randint(
                0, self.diffusion.timesteps, (lig.shape[0],),
                generator=self.generator, device=lig.device)}
        return original(self, batch)

    monkeypatch.setattr(SequenceTrainer, "_loss", loss)


def _indexed_by_t_over_T(monkeypatch):
    """Q_bar indexed by t / T, where the source indexes by alpha_bar(t)
    (Q3)."""
    from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion

    def qt_bar(self, t_int):
        idx = torch.as_tensor(t_int).reshape(-1)
        return self.transition.get_Qt_bar(idx.float() / self.timesteps)

    monkeypatch.setattr(D3PMDiffusion, "qt_bar_from_t_int", qt_bar)


def _elbo_without_softmaxed_target(monkeypatch):
    """The ELBO's KL taken against the one-hot itself (Q11 softmaxes
    it)."""
    from e3diff_tpu_torch.training import sequence

    def elbo(logits_pred, logits_target, mask=None, eps=1e-6, count=None):
        log_p = torch.log_softmax(logits_pred + eps, dim=-1)
        kl_row = (torch.xlogy(logits_target, logits_target)
                  - logits_target * log_p).sum(-1)
        nll_row = -(torch.softmax(logits_pred, dim=-1) * log_p).sum(-1)
        m = mask.to(kl_row.dtype)
        n = torch.clamp(m.sum() if count is None else count, min=1.0)
        return (kl_row * m).sum() / n + (nll_row * m).sum() / n

    monkeypatch.setattr(sequence, "elbo_loss", elbo)


def _bf16_master_weights(monkeypatch):
    """The master weights kept in bf16: each update rounded to bf16."""
    from e3diff_tpu_torch.training import optim

    original = optim.AdamW.step

    def step(self, grads):
        out = original(self, grads)
        with torch.no_grad():
            for p in self.params:
                p.copy_(p.to(torch.bfloat16))
        return out

    monkeypatch.setattr(optim.AdamW, "step", step)


def _half_train_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from e3diff_tpu_torch.training.sequence import SequenceTrainer

    original = SequenceTrainer._loss

    def loss(self, batch):
        half = batch["ligand_seq"].shape[0] // 2
        return original(self, {k: v[:half] for k, v in batch.items()})

    monkeypatch.setattr(SequenceTrainer, "_loss", loss)


def test_sound_tiny_run_follows_the_reference():
    r = drive()
    got = {k: v["value"] for k, v in r.readings.items()}
    assert got["loss_rel"] < 1e-5 and got["later_loss_rel"] < 1e-5
    assert got["grad_norm_rel"] < 1e-4 and got["change_norm_rel"] < 1e-4
    assert got["noised_unmatched"] == 0.0
    assert r.correct(), r.readings


@pytest.mark.parametrize("fault", [
    _uniform_transition, _t_exclusive, _indexed_by_t_over_T,
    _elbo_without_softmaxed_target, _bf16_master_weights,
    _unchanged_train_state, _half_train_batch])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = drive()
    assert not r.correct(), r.readings


@pytest.mark.parametrize("fault", [
    _uniform_transition, _t_exclusive, _indexed_by_t_over_T,
    _half_train_batch])
def test_the_noised_classes_are_the_step_s_own(monkeypatch, fault):
    """A fault in the step's noising shows in ``noised_unmatched``: the
    driver reads the classes the step drew, not a draw of its own."""
    fault(monkeypatch)
    r = drive()
    assert r.readings["noised_unmatched"]["value"] > 0.05, r.readings


def test_the_int8_control_is_not_correct():
    r = drive(control="int8")
    assert not r.correct(), r.readings


def test_flop_count_equals_the_program_s_gemms():
    from benchmark import program
    from e3diff_tpu_torch.utils.profiling import count_gemm_flops

    conf = {"compute_dtype": "f32", "sequence": {
        "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
        "intermediate_size": 96, "position_embedding_type": "relative_key",
        "timesteps": 50, "max_seq_len": 24, "pocket_ext": 4,
        "dropout_p": 0.1}}
    dev = torch.device("cpu")
    model = program.sequence_model(
        program.experiment(conf, "sequence"),
        program.weights(conf, "sequence", 5, dev), dev)
    b, ll, lr = 3, 16, 24
    g = torch.Generator().manual_seed(0)
    lig = torch.nn.functional.one_hot(torch.randint(0, 20, (b, ll),
                                                    generator=g), 20).float()
    rec = torch.nn.functional.one_hot(torch.randint(0, 20, (b, lr),
                                                    generator=g), 20).float()
    with torch.no_grad():
        _, counted = count_gemm_flops(lambda: model(
            torch.rand(b, 1, generator=g), lig, torch.randn(b, ll, 8,
                                                            generator=g),
            torch.ones(b, ll), rec, torch.randn(b, lr, 8, generator=g),
            torch.ones(b, lr)))
    s = flops_seq.shape_of(conf["sequence"])
    assert counted == flops_seq.forward_flops(s, b, ll, lr)
    attn, norms = flops_seq.forward_calls(s, b, ll, lr)
    assert len(attn) == 3 + 2 * 2 and sum(not a.table for a in attn) == 2
    assert len(norms) == 4 + 3 * 3 + 3 * 2 + 1


def test_the_configuration_is_a_deployment_of_its_own():
    """A configuration with another's source and reduced keys is no new
    configuration: sequence-61m names the upstream file that defines the
    sequence model's training CONFIG, which the structure configurations'
    source does not."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    configs = json.loads((root / "BENCHMARK.json").read_text())["configs"]
    seq = next(c for c in configs if c["name"] == "sequence-61m")
    assert seq["source"].endswith("/sequence_model/train_model.py")
    assert json.loads((root / seq["file"]).read_text())["source"] == \
        seq["source"]
    for c in configs:
        if c is not seq:
            assert (c["source"], sorted(c["reduced"])) != \
                (seq["source"], sorted(seq["reduced"]))
