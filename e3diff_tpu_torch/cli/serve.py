"""Serve peptide design over HTTP from two trained checkpoints (counterpart
of scripts/serve.py).

Loads the structure and sequence checkpoints (architectures from their
config.json sidecars), captures both samplers' programs for every bucket
at startup (``DesignEngine.warmup``), and serves micro-batched design
requests on fixed shapes.

Over several cards, launch one process per card with
``python -m torch.distributed.run --nproc_per_node N -m
e3diff_tpu_torch.cli.serve ...``: the ranks form a (--dp, --tp) mesh
(dp-only when neither is given), rank 0 runs the HTTP server and leads,
and the other ranks follow its device batches. ``--dist_backend gloo``
puts several ranks on one card (NCCL refuses two ranks on one GPU); its
collectives cannot be captured, so the samplers run eagerly there.

Example:
    python -m e3diff_tpu_torch.cli.serve --structure_ckpt runs/s/final.pt \\
        --sequence_ckpt runs/q/final.pt --port 8000

    curl -s localhost:8000/design -d '{"pocket": {"sequence": "ACDEF",
        "angles": [[0,0,0,0,2,2,2,2], ...], "peptide_length": 8},
        "n_designs": 4}'
"""

from __future__ import annotations

import argparse

from e3diff_tpu_torch.utils.params_io import PARAMS_DTYPES


def _ints(text: str | None) -> list[int] | None:
    return [int(b) for b in text.split(",")] if text else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--structure_ckpt", required=True)
    p.add_argument("--sequence_ckpt", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="the card to serve on ('cpu' runs the plain "
                        "versions, eagerly)")
    p.add_argument("--serve_batch_size", type=int, default=64,
                   help="batch slots per device run")
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddim")
    p.add_argument("--ddim_steps", type=int, default=25)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--seq_skip_steps", type=int, default=25,
                   help="D3PM skip-step ladder for inverse folding "
                        "(0 = the full T-step loop)")
    p.add_argument("--transition", choices=["uniform", "blosum"],
                   default="uniform")
    p.add_argument("--ligand_buckets", default=None,
                   help="comma-separated ligand padding buckets (e.g. "
                        "'16,64'); default: the checkpoint's single "
                        "ligand_max_len/max_seq_len bucket")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale of the structure "
                        "sampler (1 = off)")
    p.add_argument("--seq_guidance_scale", type=float, default=1.0,
                   help="CFG scale of the inverse-folding sampler")
    p.add_argument("--enable_cfg", action="store_true",
                   help="capture the guided programs even at scale 1, so "
                        "that requests may send their own guidance_scale "
                        "/ seq_guidance_scale (a (B,) buffer of the "
                        "program)")
    p.add_argument("--params_dtype", choices=PARAMS_DTYPES, default="f32",
                   help="weight storage of both models")
    p.add_argument("--seq_params_dtype", choices=PARAMS_DTYPES, default=None,
                   help="the sequence model's weight storage (default: "
                        "--params_dtype)")
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="micro-batching window after the first request")
    p.add_argument("--linger_ms", type=float, default=2.0,
                   help="per-slot arrival gap that keeps a batch "
                        "collecting")
    p.add_argument("--batch_buckets", default=None,
                   help="comma-separated batch-size buckets (e.g. '8,64'); "
                        "default: one shape at serve_batch_size")
    p.add_argument("--receptor_buckets", default=None,
                   help="comma-separated receptor padding buckets (e.g. "
                        "'64,128'); default: the checkpoint's max_seq_len")
    p.add_argument("--max_queue", type=int, default=None,
                   help="bound on pending request slots per queue "
                        "(default 4 x serve_batch_size; 0 = unbounded); "
                        "beyond it a request gets 429 + Retry-After")
    p.add_argument("--warmup_shapes", default=None,
                   help="comma-separated rec:lig:batch triples (e.g. "
                        "'64:16:8,64:16:64') to capture at startup instead "
                        "of every bucket combination; the others capture "
                        "at their first request")
    p.add_argument("--dp", type=int, default=None,
                   help="serve over a mesh of the torch.distributed.run "
                        "ranks: data-parallel extent (default: the world "
                        "size over --tp; batch buckets must divide by it)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel extent of the serving mesh")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the mesh's collectives (default: nccl on the "
                        "card); gloo puts several ranks on one card and "
                        "samples eagerly")
    return p


def serving_mesh(args, parser):
    """The (dp, tp) mesh of a torch.distributed.run launch (None for one
    process): explicit extents, or dp-only over every rank."""
    import os

    from e3diff_tpu_torch.parallel import initialize_multihost, make_mesh

    multi = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not multi and (args.dp or 1) * args.tp == 1:
        return None
    _, world = initialize_multihost(backend=args.dist_backend)
    dp = args.dp if args.dp is not None else world // args.tp
    if dp * args.tp != world:
        parser.error(f"--dp {dp} x --tp {args.tp} needs {dp * args.tp} "
                     f"ranks, the launch has {world}")
    return make_mesh(dp, args.tp, backend=args.dist_backend,
                     device=None if args.device == "cuda" else args.device)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)

    from e3diff_tpu_torch.serving import DesignEngine, DesignServer

    mesh = serving_mesh(args, parser)
    if mesh is not None:
        print(f"serving mesh: {mesh.shape}, rank {mesh.rank} on "
              f"{mesh.device}, {mesh.backend}", flush=True)
    print("loading checkpoints ...", flush=True)
    engine = DesignEngine.from_checkpoints(
        args.structure_ckpt, args.sequence_ckpt, device=args.device,
        mesh=mesh,
        batch_size=args.serve_batch_size, sampler=args.sampler,
        ddim_steps=args.ddim_steps, ddim_eta=args.ddim_eta,
        seq_skip_steps=args.seq_skip_steps or None,
        transition=args.transition, guidance_scale=args.guidance_scale,
        seq_guidance_scale=args.seq_guidance_scale,
        enable_cfg=args.enable_cfg, params_dtype=args.params_dtype,
        seq_params_dtype=args.seq_params_dtype,
        ligand_buckets=_ints(args.ligand_buckets),
        receptor_buckets=_ints(args.receptor_buckets),
        batch_buckets=_ints(args.batch_buckets))
    if mesh is not None and mesh.rank != 0:
        engine.follow()   # until rank 0 stops
        return
    print("capturing the samplers (warmup) ...", flush=True)
    shapes = None
    if args.warmup_shapes:
        shapes = [tuple(int(x) for x in t.split(":"))
                  for t in args.warmup_shapes.split(",")]
    engine.warmup(shapes=shapes)
    server = DesignServer(engine, host=args.host, port=args.port,
                          max_wait_ms=args.max_wait_ms,
                          linger_ms=args.linger_ms, max_queue=args.max_queue)
    print(f"serving on http://{args.host}:{server.port}  (POST /design, "
          f"POST /inverse_fold, GET /healthz, GET /stats, GET /config)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        engine.stop_followers()


if __name__ == "__main__":
    main()
