"""One rank of the port's multi-device checks (tests/test_torch_parallel.py).

Run as ``python _torch_parallel_worker.py RANK WORLD DP TP WORKDIR``: joins
a gloo job through ``file://WORKDIR/rendezvous``, builds the (DP, TP) mesh
on the CPU, runs every case of ``WORKDIR/input.pt`` (train steps of both
models, and where it has them samplers and the design engine) on its rows
and shard, and writes what it got to ``WORKDIR/rank{RANK}.pt``. Imports
torch and the port, never JAX.

Run as ``python _torch_parallel_worker.py cli RENDEZVOUS MODULE ARGS...``
with torchrun's RANK and WORLD_SIZE set: joins a gloo job through
``file://RENDEZVOUS`` (no port to pick, so concurrent tests cannot
collide), then runs ``MODULE.main(ARGS)``, whose ``--multihost`` finds the
job already joined.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from e3diff_tpu_torch.diffusion import (  # noqa: E402
    D3PMDiffusion,
    GaussianAngleDiffusion,
)
from e3diff_tpu_torch.models import (  # noqa: E402
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.ops.transitions import BlosumTransition  # noqa: E402
from e3diff_tpu_torch.parallel import (  # noqa: E402
    load_shard,
    make_mesh,
    shard_batch,
    shard_params,
)
from e3diff_tpu_torch.sampling import (  # noqa: E402
    make_sequence_sampler,
    make_structure_sampler,
)
from e3diff_tpu_torch.serving import DesignEngine  # noqa: E402
from e3diff_tpu_torch.training import (  # noqa: E402
    AdamW,
    SequenceTrainer,
    StructureTrainer,
)


def build_model(kind, cfg, state_dict, mesh):
    enc = TransformerConfig(**cfg)
    dec = dataclasses.replace(enc, add_cross_attention=True)
    cls = StructureDenoiser if kind == "structure" else SequenceDenoiser
    model = cls(enc, dec, device="cpu", seed=None, mesh=mesh)
    load_shard(model, shard_params(state_dict, mesh,
                                   rules=model.sharding_rules))
    return model


def diffusion_of(kind, timesteps):
    if kind == "structure":
        return GaussianAngleDiffusion.cosine(timesteps, device="cpu")
    return D3PMDiffusion.create(BlosumTransition(device="cpu"), timesteps,
                                device="cpu")


def train_case(case, mesh):
    kind = case["kind"]
    model = build_model(kind, case["cfg"], case["state_dict"], mesh)
    opt = AdamW(dict(model.named_parameters()), base_lr=case["lr"],
                max_epochs=1, steps_per_epoch=1, mesh=mesh,
                sharding_rules=model.sharding_rules)
    cls = StructureTrainer if kind == "structure" else SequenceTrainer
    gen = torch.Generator().manual_seed(case["seed"])
    trainer = cls(model, diffusion_of(kind, case["timesteps"]), opt,
                  accum_steps=case["accum_steps"],
                  cond_dropout=case["cond_dropout"], generator=gen,
                  mesh=mesh)
    local = shard_batch(case["batch"], mesh)
    draws = {k: local.pop(k) for k in cls.INJECTED if k in local}
    metrics = trainer.train_step(local, **draws)
    full = trainer.full_state_dict()
    # a resume: the whole state cut back onto this rank's shard
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.load_full_state_dict(full)
    reloaded = all(torch.equal(before[k], v)
                   for k, v in model.state_dict().items())
    refused = True   # neither the train step nor the eval step captures
    for capture in (trainer.capture, trainer.capture_eval):
        try:
            capture(local, **draws)
            refused = False
        except RuntimeError:
            pass
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": full["model"], "mu": full["optimizer"]["mu"],
            "local": {k: v.clone() for k, v in model.state_dict().items()},
            "next_draw": torch.rand(4, generator=gen),
            "capture_refused": refused, "reloaded": reloaded}


def sample_case(case, mesh):
    kind = case["kind"]
    model = build_model(kind, case["cfg"], case["state_dict"], mesh)
    diffusion = diffusion_of(kind, case["timesteps"])
    local = shard_batch(case["batch"], mesh)
    n = next(iter(local.values())).shape[0]
    rows = slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)
    noise = {k: v[:, rows] if v.ndim == 4 else v[rows]
             for k, v in case["noise"].items()}
    if kind == "structure":
        run = make_structure_sampler(model, diffusion, sampler="ddim",
                                     ddim_steps=case["steps"],
                                     return_trajectory=False)
        return run(local, noise=noise)[0]
    run = make_sequence_sampler(model, diffusion, diverse=True)
    return run(local, noise=noise)


def engine_case(case, mesh):
    """DesignEngine(mesh=): rank 0 designs, the other ranks follow."""
    engine = DesignEngine(
        case["cfg"], build_model("structure", case["structure_cfg"],
                                 case["structure"], mesh),
        diffusion_of("structure", case["timesteps"][0]),
        build_model("sequence", case["sequence_cfg"], case["sequence"], mesh),
        diffusion_of("sequence", case["timesteps"][1]), device="cpu",
        mesh=mesh, **case["engine"])
    if mesh.rank != 0:
        engine.follow()
        return None
    results = engine.design_records(
        case["records"], generator=torch.Generator().manual_seed(case["seed"]))
    engine.stop_followers()
    return [(r.sequence, r.angles, r.pdb) for r in results]


def main(rank, world, dp, tp, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    mesh = make_mesh(dp, tp, device="cpu")
    spec = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
    out = {"mesh": (mesh.dp_rank, mesh.tp_rank)}
    for name, case in spec["train"].items():
        out[name] = train_case(case, mesh)
    for name, case in spec.get("sample", {}).items():
        out[name] = sample_case(case, mesh)
    if "engine" in spec:
        out["engine"] = engine_case(spec["engine"], mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def cli(rendezvous, module, argv):
    import importlib

    from e3diff_tpu_torch.parallel import initialize_multihost

    initialize_multihost(backend="gloo", init_method=f"file://{rendezvous}")
    importlib.import_module(module).main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        r, w, d, t = (int(x) for x in sys.argv[1:5])
        main(r, w, d, t, sys.argv[5])
