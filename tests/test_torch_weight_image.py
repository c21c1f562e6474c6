"""The samplers' compute image of the weights (models/blocks.py::
WeightImage), on the CPU at a small size (hidden 32, 4 heads, one
layer a stack, bf16 compute): a model with f32 weights samples bit for
bit what the same weights stored ``bf16_matmul`` sample (their matrices
need no cast), and what its own casting forward gives, through both
samplers; the image follows weights loaded or stepped in place, into the
same storage; the train and eval steps keep casting the f32 weights after
a sampler has run; int8 and bf16 storage and f32 compute keep no image;
and the ``weights.image`` span and the read counters say so. The
``graphs.capture`` span's counts need the card (CUDA graphs)."""

import dataclasses

import numpy as np
import pytest
import torch

from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.models import (
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.models.blocks import _StoredWeights, weight_reads
from e3diff_tpu_torch.ops.transitions import UniformTransition
from e3diff_tpu_torch.sampling import (
    make_sequence_sampler,
    make_structure_sampler,
)
from e3diff_tpu_torch.sampling.structure import make_denoise_fn
from e3diff_tpu_torch.training.optim import AdamW
from e3diff_tpu_torch.training.structure import StructureTrainer
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.params_io import cast_inference_params

B, L_LIG, L_REC, K, T, STEPS = 2, 8, 16, 20, 20, 3
ENC = TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                        intermediate_size=64, max_position_embeddings=L_REC,
                        dtype=torch.bfloat16)
DEC = dataclasses.replace(ENC, add_cross_attention=True)


def _structure_model(seed, dtype=torch.bfloat16):
    enc = dataclasses.replace(ENC, dtype=dtype)
    return StructureDenoiser(enc, dataclasses.replace(
        enc, add_cross_attention=True), device="cpu", seed=seed)


def _sequence_model(seed):
    xavier = dict(init_style="xavier_all")
    return SequenceDenoiser(dataclasses.replace(ENC, **xavier),
                            dataclasses.replace(DEC, **xavier), device="cpu",
                            seed=seed)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lig_mask = np.ones((B, L_LIG), np.float32)
    lig_mask[0, 5:] = 0
    rec_mask = np.ones((B, L_REC), np.float32)
    rec_mask[1, 10:] = 0
    eye = np.eye(K, dtype=np.float32)
    arrays = {
        "ligand_angles": rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)),
        "ligand_attn_mask": lig_mask,
        "receptor_seq": eye[rng.integers(0, K, (B, L_REC))],
        "receptor_angles": rng.uniform(-np.pi, np.pi, (B, L_REC, 8)),
        "receptor_attn_mask": rec_mask,
    }
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in arrays.items()}


DIFFUSION = GaussianAngleDiffusion.cosine(T, device="cpu")
D3PM = D3PMDiffusion.create(UniformTransition(K), timesteps=6, device="cpu")


def _structure_draws(seed=3):
    x_init, z = DIFFUSION.draw_noise(
        (B, L_LIG, 8), STEPS, generator=torch.Generator().manual_seed(seed),
        device="cpu")
    return {"x_init": x_init, "z": z}


def _sample_structure(model, noise, batch=None):
    run = make_structure_sampler(model, DIFFUSION, sampler="ddim",
                                 ddim_steps=STEPS, return_trajectory=False)
    return run(_batch() if batch is None else batch, noise=noise)[0]


def _imaged(model):
    return [m for m in model.modules() if isinstance(m, _StoredWeights)]


def _counted(fn):
    """fn's result and the (image_reads, weight_casts) it added."""
    before = weight_reads()
    out = fn()
    return out, tuple(a - b for a, b in zip(weight_reads(), before))


def test_structure_sampler_reads_an_image_bit_for_bit_bf16_matmul():
    """f32 weights with their image, the same weights stored bf16_matmul,
    and the f32 model's own casting forward (the eager DDIM loop outside
    the sampler): the same samples, bit for bit."""
    noise = _structure_draws()
    model = _structure_model(0)
    keys = set(model.state_dict())
    got, (reads, casts) = _counted(lambda: _sample_structure(model, noise))
    assert reads > 0 and casts == 0
    assert all(m._image is not None for m in _imaged(model))
    assert set(model.state_dict()) == keys
    assert not any(t is img for m in _imaged(model) for img in m._image
                   for t in [*model.parameters(), *model.buffers()])

    stored = _structure_model(None)
    stored.load_state_dict(model.state_dict())
    cast_inference_params(stored, "bf16_matmul")
    want, (reads, casts) = _counted(lambda: _sample_structure(stored, noise))
    assert (reads, casts) == (0, 0)
    assert torch.equal(got, want)

    plain, (reads, casts) = _counted(
        lambda: DIFFUSION.sample_loop_ddim(
            make_denoise_fn(model, _batch(), guided=False),
            noise["x_init"], noise=noise["z"], n_steps=STEPS,
            return_trajectory=False)[0])
    assert reads == 0 and casts > 0
    assert torch.equal(got, plain)


def test_sequence_sampler_reads_an_image_bit_for_bit_bf16_matmul():
    batch = {**_batch(), "ligand_seq": torch.zeros(B, L_LIG, K)}
    x_init, gumbel = D3PM.draw_noise(
        (B, L_LIG), None, generator=torch.Generator().manual_seed(4),
        device="cpu")
    noise = {"x_init": x_init, "gumbel": gumbel}
    model = _sequence_model(0)
    stored = _sequence_model(None)
    stored.load_state_dict(model.state_dict())
    cast_inference_params(stored, "bf16_matmul")
    got, (reads, casts) = _counted(
        lambda: make_sequence_sampler(model, D3PM)(batch, noise=noise))
    assert reads > 0 and casts == 0
    want, (reads, casts) = _counted(
        lambda: make_sequence_sampler(stored, D3PM)(batch, noise=noise))
    assert (reads, casts) == (0, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _fresh_sample(state, noise):
    fresh = _structure_model(None)
    fresh.load_state_dict(state)
    return _sample_structure(fresh, noise)


def test_the_image_follows_weights_loaded_or_stepped_in_place():
    """One sampler on one model: after load_state_dict of other weights,
    and after an AdamW step on the model, its next call samples what a
    freshly built model with those weights samples; the image keeps its
    storage (programs captured over it stay valid)."""
    noise = _structure_draws()
    model = _structure_model(0)
    run = make_structure_sampler(model, DIFFUSION, sampler="ddim",
                                 ddim_steps=STEPS, return_trajectory=False)
    first = run(_batch(), noise=noise)[0]
    ptrs = [t.data_ptr() for m in _imaged(model) for t in m._image]

    model.load_state_dict(_structure_model(1).state_dict())
    loaded = run(_batch(), noise=noise)[0]
    assert not torch.equal(loaded, first)
    assert torch.equal(loaded, _fresh_sample(model.state_dict(), noise))

    before = [p.detach().clone() for p in model.parameters()]
    opt = AdamW(dict(model.named_parameters()), base_lr=1e-2, max_epochs=1,
                steps_per_epoch=1)
    gen = torch.Generator().manual_seed(5)
    opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))
    stepped = run(_batch(), noise=noise)[0]
    assert not torch.equal(stepped, loaded)
    assert torch.equal(stepped, _fresh_sample(model.state_dict(), noise))
    assert [t.data_ptr() for m in _imaged(model) for t in m._image] == ptrs


def _trainer():
    model = _structure_model(0)
    opt = AdamW(dict(model.named_parameters()), base_lr=1e-2, max_epochs=1,
                steps_per_epoch=2)
    return StructureTrainer(model, DIFFUSION, opt,
                            generator=torch.Generator().manual_seed(6))


def test_train_and_eval_steps_cast_the_f32_weights_after_sampling():
    """A trainer whose model a sampler has read (its image made) takes the
    same train step and eval step, bit for bit, as one whose model never
    sampled, casting its f32 weights and reading no image; a sampler
    after the step reads the stepped weights."""
    noise, batch = _structure_draws(), _batch(1)
    sampled, plain = _trainer(), _trainer()
    _sample_structure(sampled.model, noise)
    got, (reads, casts) = _counted(lambda: sampled.train_step(batch))
    assert reads == 0 and casts > 0
    want = plain.train_step(batch)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(sampled.optimizer.params,
                                                  plain.optimizer.params))

    after = _sample_structure(sampled.model, noise)
    assert torch.equal(after, _sample_structure(plain.model, noise))
    got, (reads, casts) = _counted(lambda: sampled.eval_step(batch))
    assert reads == 0 and casts > 0
    want = plain.eval_step(batch)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("storage", ["bf16_matmul", "int8_matmul", "bf16"])
def test_bf16_and_int8_storage_keep_no_image(storage):
    """Weights cast to another storage after the image was made: the next
    call drops the image; int8 dequantizes in every call."""
    noise = _structure_draws()
    model = _structure_model(0)
    _sample_structure(model, noise)
    cast_inference_params(model, storage)
    _, (reads, casts) = _counted(lambda: _sample_structure(model, noise))
    assert all(m._image is None for m in _imaged(model))
    assert reads == 0 and (casts > 0) == (storage == "int8_matmul")


def test_f32_compute_keeps_no_image():
    model = _structure_model(0, dtype=torch.float32)
    _, counts = _counted(lambda: _sample_structure(model, _structure_draws()))
    assert counts == (0, 0)
    assert all(m._image is None for m in _imaged(model))


def test_weights_image_span_counts_each_refresh():
    """A span when the image is made (every imaged tensor, 2 bytes a
    value), none while the weights stay, one when any of them changes;
    every Linear and table call of a sampler reads the image. Weights
    that want no image make no span."""
    rec = telemetry.recorder()
    rec.clear()
    noise = _structure_draws()
    model = _structure_model(0)
    run = make_structure_sampler(model, DIFFUSION, sampler="ddim",
                                 ddim_steps=STEPS, return_trajectory=False)
    sources = [getattr(m, n) for m in _imaged(model) for n in m.IMAGED]
    _, (reads, casts) = _counted(lambda: run(_batch(), noise=noise))
    (span,) = rec.spans("weights.image")
    assert span.attrs == {"tensors": len(sources),
                          "bytes": 2 * sum(t.numel() for t in sources)}
    assert span.parent == rec.spans("structure.run")[0].id
    # the encoder's calls once, the decoder's (all but the cross K/V,
    # projected once) every step
    assert casts == 0 and reads > STEPS * len(model.decoder.layer)
    run(_batch(), noise=noise)
    assert len(rec.spans("weights.image")) == 1
    with torch.no_grad():
        model.angles_predictor.dense2.bias.add_(1.0)
    run(_batch(), noise=noise)
    (_, again) = rec.spans("weights.image")   # every image, made again
    assert again.attrs == span.attrs
    cast_inference_params(model, "int8_matmul")
    run(_batch(), noise=noise)      # the images dropped, in a span
    run(_batch(), noise=noise)
    assert [s.attrs for s in rec.spans("weights.image")][2:] == [
        {"tensors": 0, "bytes": 0}]
    int8 = _structure_model(0)
    cast_inference_params(int8, "int8_matmul")
    _sample_structure(int8, noise)
    assert len(rec.spans("weights.image")) == 3
    rec.clear()
