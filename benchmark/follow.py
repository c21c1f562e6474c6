"""Following the program's samplers step by step.

A reverse-diffusion sampler is chaotic: a difference in the last bit of
one step grows, through the wrap to [-pi, pi), into a different sample.
So a sample of the timed path's sampler calls is followed step by step
from the program's own state: the window's calls are recorded (their
inputs, their draws and what they returned), a few are drawn, and each
drawn call is driven again after the window, reading the state after
every step. The run again must return, bit for bit, what the window's
call returned; then the plain reference takes each step from the
program's state before it, and its result is compared with the
program's state after it.

No class or module of the program is patched on the card. The recorder
wraps, on the instance, what the benchmark hands the program or reads
from it: the ``draw_noise`` of the diffusion object the benchmark built
(``watch_draws``; the caller knows each call's batch and output), or the
``run`` of each captured program in an engine's graph cache
(``watch_programs``; each call's batch, draws and output). A structure
call is followed through the sampler's documented seam:
``make_structure_sampler(..., return_trajectory=True)`` run on the call's
batch with its draws injected returns every step's state, and the
diffusion's ``ladder`` each step's (t, t_prev). The sequence sampler has
no trajectory: a call is driven again through ``SequenceProgram``'s
inputs, state, prepare, step and final, the one private seam left. On
the CPU, where the engine runs eager loops, the diffusions' loops are
wrapped on the instance.
"""

from __future__ import annotations

import random

import torch


def _host_copy(t):
    """A copy in ordinary host memory: a reference to the program's
    page-locked batch would keep the block from going back to its
    allocator, and every later batch would lock new memory."""
    return torch.from_numpy(torch.as_tensor(t).detach().cpu().numpy().copy())


class Recorder:
    """Records every sampler call of a window; keeps the batch and the
    draws of a seeded reservoir of ``keep`` calls per sampler kind, and of
    the others their output and ligand angles (what ties a served answer
    to its call)."""

    def __init__(self, seed: int, keep: int = 3):
        self.rng = random.Random(seed)
        self.keep = keep
        self.calls = {"structure": [], "sequence": []}
        self.kept = {"structure": [], "sequence": []}
        self.active = False
        self._undo = []
        self._batch = {}

    def _add(self, kind, call):
        if not self.active:
            return
        calls, kept = self.calls[kind], self.kept[kind]
        call["n"] = len(calls)
        calls.append(call)
        j = (len(kept) if len(kept) < self.keep
             else self.rng.randrange(len(calls)))
        if j >= self.keep:
            _drop(call)
            return
        if call.get("batch") is not None:
            call["batch"] = {k: _host_copy(v)
                             for k, v in call["batch"].items()}
        if j == len(kept):
            kept.append(call)
        else:
            _drop(kept[j])            # the evicted call's draws and batch
            kept[j] = call

    def watch_draws(self, diffusion, kind: str = "structure"):
        """Record the draws of every run of ``diffusion``'s sampler, in
        the order the runs come (``call["n"]``: the run's place)."""
        original = diffusion.draw_noise
        rec = self

        def draw_noise(*args, **kw):
            x_init, z = original(*args, **kw)
            rec._add(kind, {"draws": (x_init, z, None)})
            return x_init, z

        diffusion.draw_noise = draw_noise
        self._undo.append(lambda: delattr(diffusion, "draw_noise"))

    def watch_programs(self, cache):
        """Record every call of each captured program in ``cache`` (a
        ``GraphCache``)."""
        from e3diff_tpu_torch.sampling.sequence import SequenceProgram

        for prog in cache.values():
            self._wrap_run(prog, "sequence" if isinstance(
                prog, SequenceProgram) else "structure")

    def attach_eager(self, structure_diffusion=None, sequence_d3pm=None):
        """The CPU: the engine's eager loops."""
        from e3diff_tpu_torch.sampling import sequence, structure

        self._wrap_batches(structure, "structure")
        self._wrap_batches(sequence, "sequence")
        if structure_diffusion is not None:
            self._wrap_structure_loop(structure_diffusion)
        if sequence_d3pm is not None:
            self._wrap_sequence_loop(sequence_d3pm)

    def detach(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    # -- the card: the captured programs ----------------------------------
    def _wrap_run(self, prog, kind):
        original = prog.run
        rec = self

        def run(batch, x_init, noise, scale):
            out = original(batch, x_init, noise, scale)
            rec._add(kind, {"program": prog, "batch": dict(batch),
                            "draws": (x_init, noise, scale),
                            "out": out[0] if isinstance(out, tuple) else out})
            return out

        prog.run = run
        self._undo.append(lambda: delattr(prog, "run"))

    # -- the CPU: the eager loops -----------------------------------------
    def _wrap_batches(self, module, kind):
        """The eager loop builds its denoiser over the batch just before
        it runs: keep that batch for the loop's record."""
        original = module.make_denoise_fn
        rec = self

        def make_denoise_fn(model, batch, **kw):
            rec._batch[kind] = dict(batch)
            return original(model, batch, **kw)

        module.make_denoise_fn = make_denoise_fn
        self._undo.append(
            lambda: setattr(module, "make_denoise_fn", original))

    def _wrap_structure_loop(self, diffusion):
        original = diffusion._run
        rec = self

        def _run(denoise_fn, x_init, ts, t_prev, generator, noise,
                 return_trajectory, trajectory_dtype, ddim, eta=1.0):
            out = original(denoise_fn, x_init, ts, t_prev, generator, noise,
                           return_trajectory, trajectory_dtype, ddim, eta)
            rec._add("structure", {
                "batch": rec._batch.get("structure"),
                "draws": (x_init, noise, None), "out": out[0]})
            return out

        diffusion._run = _run
        self._undo.append(lambda: delattr(diffusion, "_run"))

    def _wrap_sequence_loop(self, d3pm):
        original = d3pm.sample_loop
        rec = self

        def sample_loop(denoise_fn, x_init, *, generator=None, gumbel=None,
                        diverse=True, n_steps=None):
            out = original(denoise_fn, x_init, generator=generator,
                           gumbel=gumbel, diverse=diverse, n_steps=n_steps)
            rec._add("sequence", {
                "eager": (d3pm, denoise_fn, diverse, n_steps),
                "batch": rec._batch.get("sequence"),
                "draws": (x_init, gumbel, None), "out": out})
            return out

        d3pm.sample_loop = sample_loop
        self._undo.append(lambda: delattr(d3pm, "sample_loop"))


def _drop(call):
    """Keep of a call only its output and its ligand angles."""
    call["draws"] = None
    if call.get("batch") is not None:
        call["batch"] = {"ligand_angles": _host_copy(
            call["batch"]["ligand_angles"])}


def _fill(buf, value):
    buf.copy_(torch.as_tensor(value).to(device=buf.device, dtype=buf.dtype)
              .expand_as(buf))


def structure_follower(model, diffusion, *, sampler: str,
                       ddim_steps: int = 50, eta: float = 1.0):
    """The program's structure sampler with its trajectory, for
    ``follow_structure`` (its programs are captured at their first
    call)."""
    from e3diff_tpu_torch.sampling.structure import make_structure_sampler

    run = make_structure_sampler(
        model, diffusion, return_trajectory=True, sampler=sampler,
        ddim_steps=ddim_steps, ddim_eta=eta)
    run.table = diffusion.ladder(sampler, n_steps=ddim_steps)
    return run


@torch.no_grad()
def follow_structure(run, call, want):
    """Drive a recorded structure call again through ``run``
    (``structure_follower``) with its batch and its draws; returns (final,
    states, table) where states[k] = (x before step k, x after) for k in
    ``want`` and table = the (t, t_prev) of every step."""
    x_init, z, scale = call["draws"]
    batch = {k: torch.as_tensor(v) for k, v in call["batch"].items()}
    final, traj = run(batch, noise={"x_init": x_init, "z": z}, scale=scale)
    states = {k: (x_init if k == 0 else traj[k - 1], traj[k])
              for k in sorted(want)}
    ts, tp = run.table
    return final, states, (list(ts), list(tp))


@torch.no_grad()
def follow_sequence(call):
    """Drive a recorded sequence call again; returns (final logits, states,
    pairs): states[k] = (x before step k, x after), then the final x."""
    x_init, gumbel, scale = call["draws"]
    states = {}
    if "program" in call:
        prog = call["program"]
        for k, buf in prog.inputs.items():
            _fill(buf, call["batch"][k])
        if prog.scale is not None:
            _fill(prog.scale, scale)
        st = prog.state
        _fill(st.x, x_init)
        if st.gumbel is not None:
            _fill(st.gumbel, gumbel)
        st.i.zero_()
        if prog.prepare is not None:
            prog.prepare.replay()
        for k in range(prog.n_steps):
            before = st.x.clone()
            prog.step.replay()
            states[k] = (before, st.x.clone())
        prog.final.replay()
        pairs = list(zip(st.s.tolist(), st.t.tolist()))
        return prog.final.out.clone(), states, pairs, st.x.clone()
    d3pm, denoise_fn, diverse, n_steps = call["eager"]
    st = d3pm.reverse_state(x_init, gumbel if diverse else None, n_steps)
    for k in range(len(d3pm.step_pairs(n_steps))):
        before = st.x.clone()
        d3pm.reverse_step(denoise_fn, st, diverse=diverse)
        states[k] = (before, st.x.clone())
    pairs = list(zip(st.s.tolist(), st.t.tolist()))
    return d3pm.final_logits(denoise_fn, st.x), states, pairs, st.x.clone()
