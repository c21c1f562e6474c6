"""CUDA graphs of the samplers' calls (they stand for the bodies of the
JAX package's jitted ``lax.scan`` samplers, e3diff_tpu/sampling/
structure.py and sequence.py) and of the trainers' train step
(training/trainer.py::CapturedStep, for the jitted train_step).

A ``CapturedCall`` captures one call -- a pocket encoding, one reverse
step, the last sequence forward -- over static device buffers, by the
standard recipe: warm the call up eagerly on a side stream (this also
builds the kernels and sets their shared-memory opt-in before any
capture), then capture it on that stream into the caller's memory pool
with ``capture_error_mode="thread_local"``, so that other threads (the
HTTP server's) may keep running while this one captures. The side stream
is PyTorch's one capture stream (``torch.cuda.graph``'s default), for
every capture of the process: cuBLAS keeps a workspace for each stream
it has run on, for the life of the process, so a new stream per capture
would hold one more workspace per capture. The caller copies its
inputs into the static buffers and replays. A call that cannot be captured
raises; nothing falls back to eager launches.

The kernels' launch counters (ops/kernels.py) move when a kernel is
launched from Python: in the warm-up and at capture, never on replay. A
capture records its own launches by kernel name in ``launches``. The
warm-up and the capture run inside a ``graphs.capture`` span
(utils/telemetry.py) whose ``owner`` names the captured call's user, and
whose ``image_reads`` and ``weight_casts`` count the Linear and distance
table calls the capture recorded (on its thread) that read the weights'
compute image and that cast or dequantized the stored weights
(models/blocks.py::weight_reads): a sampler's capture of f32 weights in
bf16 compute casts none, a train step's casts every one; and whose
``adamw_launches`` counts the launches of the fused clipping and AdamW
update (ops/kernels.py::adamw_update) the capture recorded: one a train
step, none where the step missed the kernel.

A tensor-parallel model's NCCL all-reduces are captured with the rest of
its call; a gloo mesh's collectives stage through the host and cannot
be: ``check_capturable`` refuses them.
"""

from __future__ import annotations

from typing import Callable

import torch

from e3diff_tpu_torch.models.blocks import weight_reads
from e3diff_tpu_torch.ops import kernels
from e3diff_tpu_torch.utils import telemetry

WARMUP_CALLS = 2


def _launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in kernels.KERNELS}


class CapturedCall:
    """``fn`` captured once as a CUDA graph; ``replay()`` reruns its
    device work. ``out`` is what ``fn`` returned at capture (tensors in the
    graph's pool, rewritten by every replay). ``reset`` runs before each
    warm-up call, to put the buffers ``fn`` advances (a step index) back
    in range. ``grad`` captures with autograd on (a train step's forward
    and backward), else under ``no_grad``. Each of ``generators`` (CUDA
    ``torch.Generator``s that ``fn`` draws from) is registered with the
    graph, so that every replay draws the next values of its Philox
    sequence, as an eager call would. ``owner`` (``structure``,
    ``sequence``, ``train``, ``eval``) tags the capture's span."""

    def __init__(self, fn: Callable, *, pool, reset: Callable | None = None,
                 grad: bool = False, generators: tuple = (),
                 owner: str = ""):
        with telemetry.span("graphs.capture", owner=owner) as span:
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                if not hasattr(self.graph, "register_generator_state"):
                    raise RuntimeError(
                        f"torch {torch.__version__} cannot capture draws from "
                        "a torch.Generator of the caller's "
                        "(CUDAGraph.register_generator_state is missing)")
                self.graph.register_generator_state(gen)
            capture = torch.cuda.graph(self.graph, pool=pool,
                                       capture_error_mode="thread_local")
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.set_grad_enabled(grad):
                for _ in range(WARMUP_CALLS):
                    if reset is not None:
                        reset()
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            before, reads = _launch_counts(), weight_reads()
            with torch.set_grad_enabled(grad), capture:
                self.out = fn()
            after = _launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            span.attrs["image_reads"], span.attrs["weight_casts"] = (
                now - was for now, was in zip(weight_reads(), reads))
            span.attrs["adamw_launches"] = self.launches["adamw_update"]

    def replay(self) -> None:
        self.graph.replay()

    def close(self) -> None:
        """Free the graph and what it returned."""
        self.graph.reset()
        self.out = None


def check_capturable(mesh, graphs: bool) -> None:
    """Raise when CUDA graphs would capture a gloo mesh's collectives."""
    if graphs and mesh is not None and not mesh.can_capture:
        raise RuntimeError(
            f"a {mesh.backend} mesh's collectives cannot be captured in a "
            "CUDA graph: run eagerly (train_step, or a sampler built with "
            "eager=True), or build the mesh on NCCL")


def fill_static(buf: torch.Tensor, value) -> None:
    """Copy ``value`` (a tensor anywhere, a numpy array or a number,
    broadcast to ``buf``'s shape) into a static buffer; from the host,
    through page-locked memory with an asynchronous copy."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value)
    if value.device.type == "cpu" and buf.device.type == "cuda":
        value = value.to(buf.dtype).expand_as(buf).contiguous().pin_memory()
    buf.copy_(value, non_blocking=True)
