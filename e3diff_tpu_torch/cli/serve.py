"""Serve peptide design over HTTP from two trained checkpoints (counterpart
of scripts/serve.py, on one card).

Loads the structure and sequence checkpoints (architectures from their
config.json sidecars), captures both samplers' programs for every bucket
at startup (``DesignEngine.warmup``), and serves micro-batched design
requests on fixed shapes.

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
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from e3diff_tpu_torch.serving import DesignEngine, DesignServer

    print("loading checkpoints ...", flush=True)
    engine = DesignEngine.from_checkpoints(
        args.structure_ckpt, args.sequence_ckpt, device=args.device,
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


if __name__ == "__main__":
    main()
