"""What the two trainers share: the train step (accumulated gradients
through the kernels, clipping and AdamW, EMA), eager or captured as one
CUDA graph (the counterpart of the JAX package's jitted train_step), the
eval step, eager or captured too, the resumable state and the
reference-layout weights.

On a mesh (parallel/mesh.py; the model built for it) each rank trains on
its dp rows of the global batch: every draw of the step (t, noise,
conditioning dropout, Gumbel noise, the dropout masks) is made at the
global batch's shape from the generator, which every rank seeds alike,
and the rank keeps its rows; every masked mean is divided by the global
count (its mask sum summed over dp, once per microbatch), so each rank's
loss is its share of the global loss, and the gradients and the metrics
are summed over dp. The eval step runs the whole batch on every rank.
Saves gather the tp shards (``full_state_dict``); a resume cuts a full
state to the mesh (``load_full_state_dict``).

A train step, eager or replayed, runs inside a ``train.step`` span
(utils/telemetry.py), an eval step inside ``train.eval_step``; each
names its model (``model``: the trainer's ``MODEL``) and, where the model
is on a card, times the card too.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from e3diff_tpu_torch.models.blocks import set_dropout_generator
from e3diff_tpu_torch.parallel.mesh import gather_params, shard_params
from e3diff_tpu_torch.sampling.graphs import (
    CapturedCall,
    check_capturable,
    fill_static,
)
from e3diff_tpu_torch.training.checkpoint import map_tensors
from e3diff_tpu_torch.training.optim import (
    AdamW,
    accumulated_grads,
    ema_update,
)
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.profiling import count_gemm_flops


class Trainer:
    """A model, its diffusion and its optimizer (over the model's
    parameters, built by the caller), with:

    * ``ema_decay``: 0 (off) or the decay of an EMA copy of the
      parameters, updated after each step;
    * ``accum_steps``: microbatches per step (training/optim.py::
      accumulated_grads);
    * ``cond_dropout``: the probability of replacing an example's
      conditioning with the null conditioning during training;
    * ``generator``: the one source of the noising, dropout and
      conditioning-dropout draws, on the model's device;
    * ``mesh``: the mesh the model was built for (None: one device).

    Subclasses define ``_loss(batch) -> (loss, aux dict)``, the names of
    the draws a caller may inject (``INJECTED``; on a mesh, the rank's
    rows of them), ``_metrics`` and the model their steps' spans name
    (``MODEL``)."""

    INJECTED: tuple[str, ...] = ()
    MODEL = ""

    def __init__(self, model: nn.Module, diffusion, optimizer: AdamW, *,
                 ema_decay: float = 0.0, accum_steps: int = 1,
                 cond_dropout: float = 0.0,
                 generator: torch.Generator | None = None, mesh=None):
        names = [n for n, _ in model.named_parameters()]
        if names != optimizer.names:
            raise ValueError("the optimizer does not hold the model's "
                             "parameters")
        if mesh is not getattr(model, "mesh", None):
            raise ValueError("the model was built for another mesh")
        if mesh is not None and optimizer.mesh is not mesh:
            raise ValueError("the optimizer was built for another mesh")
        self.mesh = mesh
        self.model, self.diffusion, self.optimizer = model, diffusion, optimizer
        self.ema_decay, self.accum_steps = ema_decay, accum_steps
        self.cond_dropout = cond_dropout
        self.generator = generator
        set_dropout_generator(model, generator)
        self.ema = ([p.detach().clone() for p in optimizer.params]
                    if ema_decay else None)

    # -- the mesh: the rank's rows of each draw, global counts -----------
    def _dp_split(self) -> bool:
        """A train-mode pass on a mesh: the batch is the rank's dp rows."""
        return self.mesh is not None and self.model.training

    def _draw(self, fn, n: int):
        """``fn(rows)``'s draw for the rank's ``n`` rows: drawn at the
        global rows and cut on a mesh, at ``n`` otherwise."""
        if not self._dp_split():
            return fn(n)
        r0, rows = self.mesh.rows(n)
        return fn(rows)[r0:r0 + n]

    def _global(self, counts: torch.Tensor) -> torch.Tensor:
        """A local count (or stacked counts) summed over dp in a
        train-mode pass on a mesh; as it is otherwise."""
        if not self._dp_split():
            return counts
        return self.mesh.all_reduce_dp([counts])[0]

    def _with_draws(self, batch: dict, draws: dict) -> dict:
        unknown = set(draws) - set(self.INJECTED)
        if unknown:
            raise TypeError(f"unknown injected draws {sorted(unknown)}")
        return {**batch, **{k: v for k, v in draws.items() if v is not None}}

    def loss(self, batch: dict, **draws):
        """(loss, aux) of one forward over the whole batch in the model's
        current mode, with autograd."""
        return self._loss(self._with_draws(batch, draws))

    def train_step(self, batch: dict, **draws) -> dict:
        """One optimizer step; returns the step's metrics as 0-d tensors on
        the device (no host sync): the loss and its parts, and
        ``grad_norm``, the gradients' global norm before clipping."""
        with self._span("train.step"):
            return self._step(self._with_draws(batch, draws))

    def _span(self, name: str):
        return telemetry.span(name, model=self.MODEL,
                              device=self.optimizer.params[0].is_cuda)

    def _step(self, batch: dict) -> dict:
        self.model.train()
        loss, aux, grads = accumulated_grads(
            self._loss, self.optimizer.params, batch, self.accum_steps)
        if self.mesh is not None:
            # each rank's loss is its share of the global one: sums
            grads = self.mesh.all_reduce_dp(grads)
            sums = self.mesh.all_reduce_dp([loss, *aux.values()])
            loss, aux = sums[0], dict(zip(aux, sums[1:]))
        grad_norm = self.optimizer.step(grads)
        if self.ema is not None:
            ema_update(self.ema, self.optimizer.params, self.ema_decay)
        metrics = self._metrics("train", loss, aux)
        metrics["grad_norm"] = grad_norm
        return metrics

    def capture(self, batch: dict, *, pool=None, **draws) -> "CapturedStep":
        """The train step captured as one CUDA graph for batches of
        ``batch``'s keys and shapes (and these injected draws' names): see
        CapturedStep. ``pool``: the graph's memory pool (one of its own by
        default). A step that cannot be captured raises, as does one on a
        gloo mesh on the card (gloo's collectives stage through the host:
        run ``train_step`` eagerly there)."""
        check_capturable(self.mesh, True)
        return CapturedStep(self, self._with_draws(batch, draws), pool=pool)

    @contextlib.contextmanager
    def restored(self):
        """Put the trainer's state (weights, moments, count, EMA,
        generator) back on exit as it was on entry, in the same tensors;
        the copy lives on the device meanwhile."""
        saved = map_tensors(self.state_dict(), torch.clone)
        try:
            yield
        finally:
            self.load_state_dict(saved)

    def eval_step(self, batch: dict, **draws) -> dict:
        """The validation metrics of one batch: eval mode (no dropout, no
        conditioning dropout), forward kernels only."""
        with self._span("train.eval_step"):
            return self._eval(self._with_draws(batch, draws))

    @torch.no_grad()
    def _eval(self, batch: dict) -> dict:
        self.model.eval()
        loss, aux = self._loss(batch)
        return self._metrics("val", loss, aux)

    def capture_eval(self, batch: dict, *, pool=None,
                     **draws) -> "CapturedStep":
        """The eval step captured as one CUDA graph for batches of
        ``batch``'s keys and shapes (the jitted eval step of the JAX
        package, e3diff_tpu/training/structure.py:172-173): see
        CapturedStep. Refused where ``capture`` is."""
        check_capturable(self.mesh, True)
        return CapturedStep(self, self._with_draws(batch, draws), pool=pool,
                            train=False)

    # -- checkpoints -----------------------------------------------------
    def _full(self, tensors: dict) -> dict:
        """A dict keyed by the model's state_dict keys, its tp shards
        gathered (every tp rank must call it)."""
        if self.mesh is None or self.mesh.tp == 1:
            return tensors
        return gather_params(tensors, self.mesh, self.model.sharding_rules)

    def _shard(self, tensors: dict) -> dict:
        if self.mesh is None or self.mesh.tp == 1:
            return tensors
        return shard_params(tensors, self.mesh,
                            rules=self.model.sharding_rules)

    def weights(self) -> dict[str, torch.Tensor]:
        """The model's reference-layout state_dict, f32 on the CPU (the
        whole model on a mesh: every rank must call it)."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        return {k: v.float().cpu() for k, v in self._full(sd).items()}

    def ema_weights(self) -> dict[str, torch.Tensor] | None:
        """``weights()`` with the EMA parameters, or None without EMA."""
        if self.ema is None:
            return None
        out = self.weights()
        ema = self._full(dict(zip(self.optimizer.names, self.ema)))
        for name, e in ema.items():
            out[name] = e.detach().float().cpu()
        return out

    def state_dict(self) -> dict:
        """Everything a resume needs: weights, optimizer, EMA, generator;
        the live tensors on the device, as nn.Module.state_dict gives
        them (CheckpointManager.save copies them)."""
        return {
            "model": {k: v.detach()
                      for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "ema": (None if self.ema is None else
                    dict(zip(self.optimizer.names, self.ema))),
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
        }

    def full_state_dict(self) -> dict:
        """``state_dict()`` with the tp shards gathered: the one-device
        state that a save writes (every rank must call it)."""
        state = self.state_dict()
        opt = state["optimizer"]
        return {**state, "model": self._full(state["model"]),
                "optimizer": {**opt, "mu": self._full(opt["mu"]),
                              "nu": self._full(opt["nu"])},
                "ema": None if state["ema"] is None
                else self._full(state["ema"])}

    def load_full_state_dict(self, state: dict) -> None:
        """Load a one-device state (``full_state_dict``'s, whatever mesh
        wrote it) cut to this rank's shard."""
        opt = state["optimizer"]
        self.load_state_dict({
            **state, "model": self._shard(state["model"]),
            "optimizer": {**opt, "mu": self._shard(opt["mu"]),
                          "nu": self._shard(opt["nu"])},
            "ema": None if state["ema"] is None
            else self._shard(state["ema"])})

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (state_dict's, from any device) into the
        trainer's own tensors, which keep their storage: a captured step
        goes on reading them."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint's EMA does not match ema_decay")
        if self.ema is not None:
            for name, e in zip(self.optimizer.names, self.ema):
                e.copy_(state["ema"][name])
        if self.generator is not None and state["generator"] is not None:
            self.generator.set_state(state["generator"])


class CapturedStep:
    """A trainer's train step captured as one CUDA graph: the forward,
    ``accumulated_grads`` (every microbatch), clipping, AdamW and the EMA,
    over static device copies of one batch's tensors (and its injected
    draws); or, with ``train=False``, its eval step (the forward under
    no_grad in eval mode, and the metrics). Calling it with a batch of the
    same keys and shapes copies the batch in, replays the graph, and
    returns ``metrics``: the step's metrics as static tensors, which the
    next call rewrites (a caller that keeps them queues its copy before
    the next replay, as ``MetricSums.add`` does on the same stream).

    Every draw of the step comes from the trainer's generator, which the
    graph registers: each replay draws the values the next eager step
    would. The warm-up calls before the capture take real steps, inside
    ``trainer.restored()`` (an eval step changes the generator alone, and
    only the generator is put back): the first replay is the trainer's
    next step. ``launches``: the kernels' launches at the capture, by
    name. ``gemm_flops``: the GEMMs' operations in a step, counted in the
    first warm-up call (utils/profiling.py::count_gemm_flops), for the
    digest of replays. ``writes``: the weights a train replay updates in
    place; each replay moves their version counters."""

    def __init__(self, trainer: Trainer, batch: dict, *, pool=None,
                 train: bool = True):
        if trainer.generator is None:
            raise ValueError("capturing a train or eval step needs the "
                             "trainer's generator")
        device = trainer.optimizer.params[0].device
        self.static = {}
        for k, v in batch.items():
            self.static[k] = torch.empty(tuple(v.shape), dtype=v.dtype,
                                         device=device)
            fill_static(self.static[k], v)
        flops = []

        run = trainer._step if train else trainer._eval
        self.name = "train.step" if train else "train.eval_step"
        self.span = trainer._span

        def step():
            if flops:
                return run(self.static)
            out, n = count_gemm_flops(lambda: run(self.static))
            flops.append(n)
            return out

        with trainer.restored() if train else _generator_restored(
                trainer.generator):
            self.call = CapturedCall(step, pool=pool, grad=train,
                                     generators=(trainer.generator,),
                                     owner="train" if train else "eval")
        self.gemm_flops = flops[0]
        self.writes = trainer.optimizer.params if train else []
        self.metrics = self.call.out
        self.launches = self.call.launches

    def __call__(self, batch: dict) -> dict:
        if batch.keys() != self.static.keys():
            raise ValueError(f"captured for the keys {sorted(self.static)}, "
                             f"given {sorted(batch)}")
        with self.span(self.name):
            for k, v in batch.items():
                if tuple(v.shape) != tuple(self.static[k].shape):
                    raise ValueError(f"{k}: captured for shape "
                                     f"{tuple(self.static[k].shape)}, given "
                                     f"{tuple(v.shape)}")
                fill_static(self.static[k], v)
            self.call.replay()
            if self.writes:
                # the replay wrote the weights where autograd's version
                # counters cannot see it: move them, as an eager step's
                # in-place update does (a sampler's compute image reads
                # them, models/blocks.py::WeightImage)
                torch.autograd.graph.increment_version(self.writes)
        return self.metrics

    def close(self) -> None:
        self.call.close()
        self.metrics = None


@contextlib.contextmanager
def _generator_restored(generator: torch.Generator):
    """Put ``generator`` back on exit where it was on entry."""
    state = generator.get_state()
    try:
        yield
    finally:
        generator.set_state(state)
