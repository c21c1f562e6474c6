"""What the captured train step rests on, on the CPU at a small size
(hidden 32, 1 layer, B 4). The graph itself runs only on the card
(chip_smoke.py holds 20 replays to 20 eager steps bit for bit there); here
the plain parts: AdamW's device schedule table and in-place state, a
trainer's state loaded into its own tensors, the warm-up's save and
restore, the epoch means of a step that rewrites its metrics, the
snapshot checkpoint saves, and the profile digest.

Tolerances: AdamW against its old host-scalar arithmetic exactly (the same
float32 operations), against optax (the JAX package) to 1e-6 absolute as
tests/test_torch_training.py holds it; trainer states and checkpoint
files exactly; epoch means to 1e-6 relative (float32 sums of 5 values);
the digest of a hand-written trace exactly (sums of integers of
microseconds).
"""

import dataclasses
import json
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e3diff_tpu.training import optim as j_optim

from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion
from e3diff_tpu_torch.models import StructureDenoiser, TransformerConfig
from e3diff_tpu_torch.training import AdamW, StructureTrainer
from e3diff_tpu_torch.training.checkpoint import CheckpointManager
from e3diff_tpu_torch.training.loop import MetricSums, train_loop
from e3diff_tpu_torch.training.optim import linear_warmup_per_epoch
from e3diff_tpu_torch.utils import profiling
from e3diff_tpu_torch.utils.timing import profiler_trace

B, L_REC, L_LIG, K = 4, 16, 8, 20


# ------------------------------------------------------------------ AdamW

class HostScalarAdamW:
    """The AdamW step as the port took it before its state moved to the
    device: the learning rate and both bias corrections as Python floats
    from a host count, new moment lists every step (the oracle)."""

    def __init__(self, params, *, base_lr, weight_decay, max_epochs,
                 steps_per_epoch, grad_clip, mu_dtype, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = params
        self.schedule = linear_warmup_per_epoch(base_lr, max_epochs,
                                                steps_per_epoch)
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = torch.bfloat16 if mu_dtype == "bf16" else None
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        norms = torch._foreach_norm([g.float() for g in grads])
        norm = torch.linalg.vector_norm(torch.stack(norms))
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                     self.grad_clip)
        keep = norm < self.grad_clip
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        b1, b2 = self.b1, self.b2
        b1_mu = float(torch.tensor(b1, dtype=self.mu[0].dtype))
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(self.mu, b1_mu))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(self.nu, b2))
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            updates = torch._foreach_add(
                updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(updates, -lr))
        self.mu = [m if self.mu_dtype is None else m.to(self.mu_dtype)
                   for m in mu]
        self.nu = list(nu)
        return norm


@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_adamw_device_state_matches_host_arithmetic_and_optax(mu_dtype):
    """12 steps at 4 steps per epoch (epoch 0 at learning rate 0, Q12;
    then epochs 1 and 2), clipped on every other step: the device table and
    in-place moments give the old arithmetic's weights, moments and norms
    bit for bit, and optax's weights to 1e-6; the state tensors keep their
    storage."""
    rng = np.random.default_rng(3)
    shapes = {"dense.weight": (5, 3), "dense.bias": (5,), "norm.weight": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.8 if i % 2 == 0 else 0.08)).astype(
        np.float32) for k, s in shapes.items()} for i in range(12)]
    kw = dict(base_lr=1e-2, weight_decay=0.1, max_epochs=10,
              steps_per_epoch=4, grad_clip=1.0, mu_dtype=mu_dtype)
    new = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in init.items()}
    old = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in new]
    opt, ref = AdamW(new, **kw), HostScalarAdamW(old, **kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx = j_optim.make_optimizer(jparams, **kw)
    jstate = tx.init(jparams)
    ptrs = [t.data_ptr() for t in [opt.count, *opt.mu, *opt.nu]]
    for step, g in enumerate(grads):
        norm = opt.step([torch.from_numpy(g[k]) for k in opt.names])
        want = ref.step([torch.from_numpy(g[k]) for k in opt.names])
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert torch.equal(norm, want), step
        for p, q, k in zip(opt.params, old, opt.names):
            assert torch.equal(p, q), (step, k)
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"step {step} {k}")
        for a, b in zip(opt.mu + opt.nu, ref.mu + ref.nu):
            assert a.dtype == b.dtype and torch.equal(a, b), step
    assert int(opt.count) == 12
    assert [t.data_ptr() for t in [opt.count, *opt.mu, *opt.nu]] == ptrs
    # the schedule table reads the old schedule's learning rate at each step
    assert opt.table[:, 0].tolist() == [ref.schedule(r)
                                        for r in range(len(opt.table))]


def test_adamw_past_its_schedule_reads_learning_rate_zero():
    """A count past max_epochs * steps_per_epoch reads the table's last
    row, where the learning rate is 0: the weights stay."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW({"w": p}, base_lr=1e-2, max_epochs=2, steps_per_epoch=1,
                weight_decay=0.1)
    assert len(opt.table) == 3 and opt.table[-1, 0].item() == 0.0
    opt.count.fill_(7)
    opt.step([torch.full((3,), 0.5)])
    assert torch.equal(p, torch.ones(3)) and int(opt.count) == 8


# ------------------------------------------------------------- the trainer

def _batch(seed=0):
    rng = np.random.default_rng(seed)
    rec_mask = np.ones((B, L_REC), np.float32)
    rec_mask[0, 12:] = 0
    lig_mask = np.ones((B, L_LIG), np.float32)
    lig_mask[0, 6:] = 0
    return {
        "ligand_angles": torch.from_numpy(rng.uniform(
            -np.pi, np.pi, (B, L_LIG, 8)).astype(np.float32)),
        "ligand_attn_mask": torch.from_numpy(lig_mask),
        "receptor_seq": torch.from_numpy(np.eye(K, dtype=np.float32)[
            rng.integers(0, K, (B, L_REC))]),
        "receptor_angles": torch.from_numpy(rng.uniform(
            -np.pi, np.pi, (B, L_REC, 8)).astype(np.float32)),
        "receptor_attn_mask": torch.from_numpy(rec_mask),
    }


def _trainer(seed=0):
    """Hidden 32, 1 layer, dropout 0.1 and conditioning dropout 0.2 (every
    draw from the trainer's generator), an EMA and bf16 moments."""
    enc = TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                            intermediate_size=64, max_position_embeddings=16,
                            dropout=0.1, attention_dropout=0.1)
    model = StructureDenoiser(enc, dataclasses.replace(
        enc, add_cross_attention=True), device="cpu", seed=seed)
    opt = AdamW(dict(model.named_parameters()), base_lr=1e-2, max_epochs=4,
                steps_per_epoch=2, mu_dtype="bf16")
    return StructureTrainer(
        model, GaussianAngleDiffusion.cosine(20, device="cpu"), opt,
        ema_decay=0.9, cond_dropout=0.2,
        generator=torch.Generator().manual_seed(seed))


def _state_tensors(trainer):
    opt = trainer.optimizer
    return [*opt.params, *opt.mu, *opt.nu, opt.count, *trainer.ema]


def _assert_same_state(a, b):
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_load_state_dict_keeps_storage_and_resumes(tmp_path):
    """2 steps, a save through CheckpointManager, a load into a fresh
    trainer (every parameter, moment, EMA and the count keep their
    data_ptr and take the saved values), 2 more steps: the 4-step run's
    state, bit for bit."""
    batch = _batch()
    whole = _trainer()
    for _ in range(4):
        whole.train_step(batch)
    first = _trainer()
    for _ in range(2):
        first.train_step(batch)
    manager = CheckpointManager(str(tmp_path))
    manager.save("last", {"trainer": first.state_dict()})
    manager.close()
    resumed = _trainer()
    ptrs = [t.data_ptr() for t in _state_tensors(resumed)]
    resumed.load_state_dict(manager.load("last")["trainer"])
    assert [t.data_ptr() for t in _state_tensors(resumed)] == ptrs
    _assert_same_state(resumed, first)
    for _ in range(2):
        resumed.train_step(batch)
    _assert_same_state(resumed, whole)


def test_restored_puts_the_trainer_back_for_the_capture():
    """The capture's warm-up steps run inside ``restored()``: afterwards
    the state is bit for bit what it was, in the same tensors, and the
    next step is the one an untouched trainer takes."""
    batch = _batch()
    trainer, twin = _trainer(), _trainer()
    trainer.train_step(batch)
    twin.train_step(batch)
    ptrs = [t.data_ptr() for t in _state_tensors(trainer)]
    with trainer.restored():
        for _ in range(2):
            trainer.train_step(batch)
    assert [t.data_ptr() for t in _state_tensors(trainer)] == ptrs
    _assert_same_state(trainer, twin)
    got, want = trainer.train_step(batch), twin.train_step(batch)
    assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(trainer, twin)


class ReplayLikeTrainer:
    """A trainer stand-in whose train_step rewrites and returns the same
    tensors every call, as a captured step's replay does."""

    mesh = None

    def __init__(self, losses):
        self.losses = iter(losses)
        self.metrics = {"train_loss": torch.zeros(()),
                        "grad_norm": torch.zeros(())}

    def train_step(self, batch):
        loss = next(self.losses)
        self.metrics["train_loss"].fill_(loss)
        self.metrics["grad_norm"].fill_(2 * loss)
        return self.metrics


def test_train_loop_means_of_a_step_that_reuses_its_tensors():
    losses = [0.5, 1.0, 2.0, 4.0, 8.5]
    history = train_loop(
        ReplayLikeTrainer(losses), lambda epoch: [{"x": np.zeros(2)}] * 5,
        None, max_epochs=1, device="cpu", log_fn=lambda s: None)
    want = float(np.mean(losses))
    assert history[0]["train_loss"] == pytest.approx(want, rel=1e-6)
    assert history[0]["grad_norm"] == pytest.approx(2 * want, rel=1e-6)
    sums = MetricSums()
    assert sums.means() == {}


# ------------------------------------------------------------- checkpoints

def test_snapshot_and_synchronous_saves_write_the_same_bytes(monkeypatch,
                                                           tmp_path):
    """The two kinds of save write the same file; a snapshot holds the
    state as it was at save(), whatever steps follow before it is
    written."""
    trainer = _trainer()
    files = []
    for _ in range(2):
        trainer.train_step(_batch())
        state = {"trainer": trainer.state_dict(), "epoch": 3, "best": 0.25}
        for env in ("1", "0"):
            monkeypatch.setenv("E3DIFF_SNAPSHOT_SAVES", env)
            manager = CheckpointManager(str(tmp_path / f"{len(files)}"))
            files.append(manager.save("last", state))
            trainer.train_step(_batch())   # moves the live tensors
            manager.close()
            # the next state's saves start from the same step
            trainer.load_state_dict(manager.load("last")["trainer"])
    data = [open(p, "rb").read() for p in files]
    assert data[0] == data[1] and data[2] == data[3] and data[0] != data[2]
    assert sorted(p.name for p in tmp_path.rglob("*")
                  if p.is_file()) == ["last.pt"] * 4


def test_snapshot_saves_env_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("E3DIFF_SNAPSHOT_SAVES", "0")
    assert not CheckpointManager(str(tmp_path)).snapshot_saves
    monkeypatch.delenv("E3DIFF_SNAPSHOT_SAVES")
    assert CheckpointManager(str(tmp_path)).snapshot_saves


def test_a_third_snapshot_waits_for_a_slot(monkeypatch, tmp_path):
    monkeypatch.setenv("E3DIFF_SNAPSHOT_SAVES", "1")
    manager = CheckpointManager(str(tmp_path))
    release = threading.Event()
    write = manager._write

    def slow_write(name, obj):
        assert release.wait(timeout=30)
        write(name, obj)

    manager._write = slow_write
    for name in ("a", "b"):
        manager.save(name, {"x": torch.ones(2)})   # returns at once
    third = threading.Thread(target=manager.save,
                             args=("c", {"x": torch.zeros(2)}))
    third.start()
    third.join(timeout=0.5)
    assert third.is_alive()          # two snapshots alive: it waits
    release.set()
    third.join(timeout=30)
    assert not third.is_alive()
    manager.close()
    assert [manager.load(n)["x"].tolist() for n in "abc"] == [
        [1.0, 1.0], [1.0, 1.0], [0.0, 0.0]]


def test_a_writer_error_is_raised_at_close_and_leaves_no_temp_file(
        monkeypatch, tmp_path):
    monkeypatch.setenv("E3DIFF_SNAPSHOT_SAVES", "1")
    manager = CheckpointManager(str(tmp_path))
    manager.save("good", {"x": torch.ones(2)})
    manager.save("bad", {"x": torch.ones(2), "f": lambda: None})  # unpicklable
    with pytest.raises(RuntimeError, match="background checkpoint save") as e:
        manager.close()
    assert e.value.__cause__ is not None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["good.pt"]
    manager.close()     # raised once
    # the next save raises a pending error too
    manager.save("bad", {"f": lambda: None})
    manager.wait()
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        manager.save("good", {"x": torch.ones(2)})


# ------------------------------------------------------------- profiling

def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7, "args": args}


HAND_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    _event("aten::addmm", "cpu_op", 0, 40,
           **{"Input Dims": [[64], [128, 32], [32, 64], [], []]}),
    _event("aten::bmm", "cpu_op", 45, 10,
           **{"Input Dims": [[4, 8, 16], [4, 16, 2]]}),
    _event("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_cublas", "kernel",
           10, 20),
    _event("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTN", "kernel", 25, 10),
    _event("void attention_mma_kernel<true, 64>(Params)", "kernel", 50, 8),
    _event("void layernorm_vec_kernel<__nv_bfloat16>(LnParams)", "kernel",
           60, 4),
    _event("void layernorm_vec_kernel<__nv_bfloat16>(LnParams)", "kernel",
           66, 4),
    _event("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::GeluCUDAKernelImpl>", "kernel", 72, 3),
    _event("void at::native::(anonymous namespace)::"
           "distribution_elementwise_grid_stride_kernel<float, 4>", "kernel",
           76, 2),
    _event("void at::native::multi_tensor_apply_kernel<TensorListMetadata>",
           "kernel", 80, 6),
    _event("void at::native::reduce_kernel<512, 1>", "kernel", 88, 2),
    _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 90, 5),
    _event("Memset (Device)", "gpu_memset", 96, 1),
    _event("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::FillFunctor<float>>", "kernel", 97, 1),
    _event("void at::native::index_select_kernel", "kernel", 98, 2),
    _event("cudaLaunchKernel", "cuda_runtime", 0, 100),
]}


def test_digest_of_a_hand_written_trace():
    totals = profiling.device_op_totals(HAND_TRACE)
    assert sum(t["count"] for t in totals.values()) == 13
    assert totals["void layernorm_vec_kernel<__nv_bfloat16>(LnParams)"] == {
        "us": 8.0, "count": 2}
    assert profiling.bucketize(totals, steps=2) == {
        "gemm": 0.015, "port:layernorm_vec_kernel": 0.004,
        "port:attention_mma_kernel": 0.004, "copy_memset": 0.0035,
        "foreach": 0.003, "elementwise": 0.0015, "random": 0.001,
        "reduction": 0.001, "other": 0.001}
    # busy: [10, 35) + [50, 58) + [60, 64) + [66, 70) + [72, 75) + [76, 78)
    # + [80, 86) + [88, 95) + [96, 100) = 25 + 8 + 4 + 4 + 3 + 2 + 6 + 7 + 4
    # over the window [0, 100)
    assert profiling.device_idle_share(HAND_TRACE) == pytest.approx(
        1 - 63 / 100, abs=1e-12)
    flops = 2 * 128 * 32 * 64 + 2 * 4 * 8 * 16 * 2
    assert profiling.gemm_flops(HAND_TRACE) == flops
    roof = profiling.roofline(totals, 2, flops)
    assert roof["ms_per_step"] == pytest.approx(0.034, abs=1e-12)
    assert roof["gemm_ms_per_step"] == pytest.approx(0.015, abs=1e-12)
    assert roof["gemm_tflops_per_s"] == pytest.approx(
        flops / 30e-6 / 1e12, rel=1e-12)
    assert profiling.top_ops(totals, n=1, steps=2)[0][:2] == (
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_cublas", "gemm")
    d = profiling.digest(HAND_TRACE, 2)
    assert d["on_device"] and d["device_idle_share"] == pytest.approx(0.37)


def test_digest_of_a_cpu_profile_of_the_tiny_trainer(tmp_path):
    """A CPU run has no device events: the digest sums the host ops' self
    times (nonzero, GEMMs among them) and gives no idle share."""
    trainer = _trainer()
    batch = _batch()
    with profiler_trace(str(tmp_path)) as path:
        for _ in range(2):
            trainer.train_step(batch)
    trace = profiling.load_trace(path)
    assert json.loads((tmp_path / "trace.json").read_text()) == trace
    totals = profiling.device_op_totals(trace)
    assert totals and all(t["us"] >= 0 and t["count"] > 0
                          for t in totals.values())
    d = profiling.digest(trace, 2)
    assert not d["on_device"] and d["device_idle_share"] is None
    assert d["buckets"]["gemm"] > 0 and profiling.gemm_flops(trace) > 0
    with profiler_trace(None) as nothing:
        assert nothing is None


def test_counted_gemm_flops_equal_the_traced_ones(tmp_path):
    """count_gemm_flops (what a captured step reports, for a trace of
    replays that holds no host GEMM op) counts one train step's GEMMs,
    forward and backward, as gemm_flops counts them in the step's trace;
    the digest takes a given count in place of the trace's. Exact: both
    are sums of integers."""
    trainer = _trainer()
    batch = _batch()
    with profiler_trace(str(tmp_path)) as path:
        trainer.train_step(batch)
    traced = profiling.gemm_flops(profiling.load_trace(path))
    metrics, counted = profiling.count_gemm_flops(
        lambda: trainer.train_step(batch))
    assert set(metrics) >= {"train_loss", "grad_norm"}
    assert counted == traced > 0
    d = profiling.digest(HAND_TRACE, 2, flops=3e6)
    assert d["roofline"]["gemm_tflops_per_s"] == pytest.approx(
        3e6 / 30e-6 / 1e12, rel=1e-12)
