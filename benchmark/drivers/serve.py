"""An open loop of /design requests to the program's DesignServer.

Set-up builds both models with the benchmark's weights, the engine with
the configuration's buckets, captures every bucket's two programs
(``DesignEngine.warmup``), starts the server on an ephemeral port of
127.0.0.1 and sends one request of each ligand bucket through it. A
client process (so that it takes no share of the server's interpreter
lock) then sends the mix's requests at their due times, Poisson arrivals
at the mix's rate, each on its own connection, and times each from when
it was due to when its reply had been read. Every request due in the
window counts; one that fails or is refused counts as lasting until the
client gave up waiting. The window is followed by a wait of up to a
minute for the last replies.

Correctness: every answer drawn for the check must be one that the
program's samplers returned (its angles a row of a structure call's
output, its sequence the argmax of the matching sequence call's logits),
its PDB the reference NERF of its angles, and a seeded few of the
window's sampler calls are followed step by step (benchmark/follow.py).
"""

from __future__ import annotations

import http.client
import json
import math
import multiprocessing as mp
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import generate


# -- the client process ---------------------------------------------------

def _client(port, bodies, due, conn):
    """Say it is ready, take the window's start from the pipe, send
    ``bodies[i]`` at ``start + due[i]`` (time.monotonic, which is one
    clock for every process of the host); report per request (sent,
    done, status) and every answer's body."""
    conn.send("ready")
    start = conn.recv()
    out = [None] * len(bodies)
    kept = {}

    def one(i):
        sent = time.monotonic()
        status, body = 0, b""
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request("POST", "/design", body=bodies[i],
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            body = r.read()
            status = r.status
            c.close()
        except (OSError, http.client.HTTPException):
            status = -1
        out[i] = (sent, time.monotonic(), status)
        if status == 200:
            kept[i] = body

    with ThreadPoolExecutor(max_workers=256) as pool:
        futures = []
        for i in range(len(bodies)):
            wait = start + due[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    conn.send((out, kept))
    conn.close()


def _post(port, body) -> int:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        c.request("POST", "/design", body=body,
                  headers={"Content-Type": "application/json"})
        resp = c.getresponse()
        resp.read()
        return resp.status
    finally:
        c.close()


def _bodies(reqs):
    return [json.dumps({
        "pocket": {"sequence": r["sequence"], "angles": r["angles"].tolist(),
                   "peptide_length": r["peptide_length"]},
        "n_designs": r["n_designs"], "return_pdb": True,
        "return_angles": True}).encode() for r in reqs]


def nearest_rank(values, q):
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def latencies(results, due, start, give_up):
    """Each request's seconds from when it was due (``start + due[i]``) to
    when its reply had been read; a request that failed or was refused
    counts as lasting ``give_up``. Returns (latencies, failures)."""
    out, failed = [], 0
    for (sent, done, status), d in zip(results, due):
        if status == 200:
            out.append(done - (start + d))
        else:
            failed += 1
            out.append(give_up)
    return out, failed


# -- the run ------------------------------------------------------------

def run(r):
    import torch

    from benchmark import program
    from benchmark.follow import (Recorder, follow_sequence,
                                  follow_structure, structure_follower)
    from benchmark.harness import Profiler
    from e3diff_tpu_torch.serving import DesignEngine, DesignServer
    from e3diff_tpu_torch.utils import builders

    conf, mix, dev = r.config, r.mix, r.device
    serving = conf["serving"]
    scfg = program.experiment(conf, "structure")
    qcfg = program.experiment(conf, "sequence")
    smodel = program.structure_model(
        scfg, program.weights(conf, "structure", r.seed_for("w.s"), dev), dev)
    qmodel = program.sequence_model(
        qcfg, program.weights(conf, "sequence", r.seed_for("w.q"), dev), dev)
    params = "int8_matmul" if r.control == "int8" else conf["params_dtype"]
    program.store(smodel, params)
    program.store(qmodel, params)
    sdiff = builders.build_structure_diffusion(scfg, device=dev)
    qd3pm = builders.build_sequence_diffusion(qcfg, serving["transition"],
                                              device=dev)
    a = conf["assumed"]
    engine = DesignEngine(
        scfg, smodel, sdiff, qmodel, qd3pm, device=dev,
        batch_size=a["serve_batch_size"], sampler=serving["sampler"],
        ddim_steps=serving["ddim_steps"], ddim_eta=serving["ddim_eta"],
        seq_skip_steps=serving["seq_skip_steps"],
        ligand_buckets=a["ligand_buckets"],
        receptor_buckets=a["receptor_buckets"],
        batch_buckets=a["batch_buckets"])
    rec = Recorder(r.seed_for("follow"), keep=r.spec.get("follow_calls", 3))
    if dev.type != "cuda":
        rec.attach_eager(sdiff, qd3pm)
    engine.warmup(generator=torch.Generator(device=dev).manual_seed(
        r.seed_for("warmup")))
    if dev.type == "cuda":
        rec.watch_programs(engine.graphs)
    design_slots = engine.design_slots
    prof = Profiler(r, torch)
    prof.warm()
    traced = {}     # the trace's stretch of the window (time.monotonic)

    def timed_design_slots(*args, **kw):
        # the batcher's thread launches the device work: the profiler
        # starts and stops there, at the calls' edges. It slows the
        # calls it records, and its stop takes seconds and stalls the
        # server, so the counters and spans are read up to its start
        now = time.monotonic()
        if traced and traced["from"] <= now < traced["to"] \
                and "stats" not in traced:
            traced["stats"] = server.batcher.stats()
            traced["spans"] = len(r.spans.get("engine.design_slots", []))
            prof.start()
            r.facts["trace_start_s"] = time.monotonic() - now
        elif traced and now >= traced["to"] and "stop" not in traced:
            traced["stop"] = True
            prof.stop()
            r.facts["trace_stop_s"] = time.monotonic() - now
        with r.span("engine.design_slots"):
            return design_slots(*args, **kw)

    engine.design_slots = timed_design_slots
    server = DesignServer(engine, host="127.0.0.1", port=0,
                          max_wait_ms=serving["max_wait_ms"],
                          linger_ms=serving["linger_ms"])
    server.start()
    try:
        _serve(r, server, rec, traced)
    finally:
        server.shutdown()
    prof.finish()
    r.memory_peak = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)
    rec.active = False

    # the check: follow a few calls through the same programs, then free
    # the program and run the reference
    followed = []
    follower = structure_follower(smodel, sdiff, sampler=serving["sampler"],
                                  ddim_steps=serving["ddim_steps"],
                                  eta=serving["ddim_eta"])
    for call in rec.kept["structure"]:
        ts_want = set(range(serving["ddim_steps"]))
        final, states, table = follow_structure(follower, call, ts_want)
        followed.append(("structure", call, final, states, table))
    for call in rec.kept["sequence"]:
        final, states, pairs, last_x = follow_sequence(call)
        followed.append(("sequence", call, final, states, (pairs, last_x)))
    answers = r.facts.pop("answers")
    tie = _tie(answers, rec)
    rec.detach()
    del engine, server, smodel, qmodel, design_slots, follower
    rec.calls = None
    program.free()
    _check(r, conf, followed, answers, tie, torch)


def _serve(r, server, rec, traced):
    mix, seconds = r.mix, r.seconds
    due = generate.arrivals(mix, seconds, r.seed)
    n = len(due)
    reqs = generate.pocket_requests(mix, n, r.seed, rotate=True)
    bodies = _bodies(reqs)
    # the server path warmed at every bucket the window uses: one request
    # of each ligand bucket alone (batch bucket 16), then for each a
    # burst of 8 requests of 8 designs at once (batch bucket 64)
    warm = generate.pocket_requests({**mix, "base_seed": mix["base_seed"] + 7},
                                    18, r.seed_for("warm"))
    peps = [5, 12] + [5] * 8 + [12] * 8
    groups = [[0], [1], list(range(2, 10)), list(range(10, 18))]
    bodies_w = []
    for body, pep in zip(_bodies(warm), peps):
        req = json.loads(body)
        req["pocket"]["peptide_length"] = pep
        req["n_designs"] = 8 if len(bodies_w) >= 2 else 1
        bodies_w.append(json.dumps(req).encode())
    with ThreadPoolExecutor(max_workers=8) as pool:
        for group in groups:
            codes = list(pool.map(
                lambda i: _post(server.port, bodies_w[i]), group))
            if any(c != 200 for c in codes):
                raise RuntimeError(f"warm-up requests failed: {codes}")
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_client, args=(server.port, bodies, due, child))
    proc.start()
    child.close()
    if not parent.poll(120):
        proc.kill()
        proc.join()
        raise RuntimeError("the client process did not start")
    parent.recv()
    start = time.monotonic() + 0.05
    parent.send(start)
    while time.monotonic() < start:
        time.sleep(0.001)
    rec.active = True
    r.setup_s = start - r.t0
    stats0 = server.batcher.stats()
    if r.trace:
        t_from = start + seconds - r.mix["trace_end_s"] - r.mix["trace_s"]
        traced.update({"from": t_from, "to": t_from + r.mix["trace_s"]})
    got = parent.recv() if parent.poll(seconds + 150) else None
    proc.join(30)
    if proc.is_alive():
        proc.kill()
        proc.join()
    stats1 = traced.get("stats") or server.batcher.stats()
    if "spans" in traced:
        del r.spans["engine.design_slots"][traced["spans"]:]
    if got is None:
        raise RuntimeError("the client sent no results")
    results, kept = got
    lat, failed = latencies(results, due, start, seconds + 90.0)
    late = [sent - (start + d) for (sent, _, _), d in zip(results, due)]
    r.attempted, r.failed = n, failed
    r.metrics["design_p95_s"] = nearest_rank(lat, 0.95)
    designs = sum(reqs[i]["n_designs"] for i, (_, done, status)
                  in enumerate(results)
                  if status == 200 and done <= start + seconds)
    r.metrics["setup_s"] = r.setup_s
    d_batches = stats1["batches"] - stats0["batches"]
    d_slots = stats1["batched_slots"] - stats0["batched_slots"]
    r.counters.update({"batches": d_batches, "batched_slots": d_slots,
                       "rejected": stats1["rejected"] - stats0["rejected"]})
    sent_late = sorted(late)
    print(f"serve: {n} requests due in {seconds:g} s at "
          f"{r.mix['rate_rps']:g}/s, {failed} failed or refused "
          f"({r.counters['rejected']} slots rejected), p50 "
          f"{nearest_rank(lat, 0.5):.4f} s, p95 "
          f"{r.metrics['design_p95_s']:.4f} s, p99 "
          f"{nearest_rank(lat, 0.99):.4f} s, designs answered in the "
          f"window {designs / seconds:.3f}/s; client lateness p50 "
          f"{nearest_rank(sent_late, 0.5) * 1e3:.2f} ms, max "
          f"{sent_late[-1] * 1e3:.2f} ms; batches {d_batches}, slots "
          f"{d_slots}; unanswered at mid-window "
          f"{_backlog(results, start + seconds / 2)}, at the close "
          f"{_backlog(results, start + seconds)}; the profiler's start "
          f"{r.facts.get('trace_start_s')} s, stop "
          f"{r.facts.get('trace_stop_s')} s", file=sys.stderr)
    # the answers checked: a seeded sample of the requests answered
    done = sorted(kept)
    pick = np.random.default_rng(r.seed_for("answers")).choice(
        len(done), size=min(len(done), r.spec.get("answers_checked", 16)),
        replace=False)
    r.facts["answers"] = {done[i]: (reqs[done[i]], json.loads(kept[done[i]]))
                          for i in pick}


def _backlog(results, at):
    """Requests sent by ``at`` and not answered by then."""
    return sum(1 for sent, done, _ in results if sent <= at < done)


def _tie(answers, rec):
    """Each checked design's angles must be a row prefix of a structure
    call's output and its sequence the argmax of the matching sequence
    call's logits; returns the count that is not, and the designs."""
    import torch

    from benchmark.generate import AA

    lengths = {len(d["angles"]) for _, reply in answers.values()
               for d in reply["designs"]}
    rows = set()
    for call in rec.calls["structure"]:
        for row in call["out"].float().cpu().numpy():
            rows.update(row[:n].tobytes() for n in lengths)
    seqs = {}
    for call in rec.calls["sequence"]:
        ang = torch.as_tensor(call["batch"]["ligand_angles"]).float().cpu()
        tok = call["out"].float().argmax(-1).cpu().numpy()
        for a_row, t_row in zip(ang.numpy(), tok):
            for n in lengths:
                seqs[a_row[:n].tobytes()] = "".join(AA[j] for j in t_row[:n])
    unmatched, designs = 0, []
    for req, reply in answers.values():
        for d in reply["designs"]:
            ang = np.asarray(d["angles"], np.float32)
            n = len(ang)
            key = ang.tobytes()
            ok = (key in rows and seqs.get(key) == d["sequence"]
                  and n == req["peptide_length"])
            unmatched += 0 if ok else 1
            designs.append(d)
    return unmatched, designs


def _check(r, conf, followed, answers, tie, torch):
    from benchmark import compare
    from benchmark.program import weights
    from benchmark.reference import nets
    from benchmark.reference.diffusion import D3PM, Gaussian

    nets.set_exact_float32()
    dev, serving = r.device, conf["serving"]
    unmatched, designs = tie
    r.read("answers_unmatched", unmatched if designs else math.inf)
    r.read("pdb_gap_A", max((compare.pdb_gap(d["pdb"], d["angles"],
                                             control=r.control != "none")
                             for d in designs if "pdb" in d), default=0.0)
           if all("pdb" in d for d in designs) else math.inf)
    replay = 0.0
    s_ctx = nets.Ctx(weights(conf, "structure", r.seed_for("w.s"), dev),
                     conf["structure"]["num_attention_heads"],
                     conf["structure"]["max_seq_len"],
                     t_dtype=getattr(torch, _dtype(conf)))
    diff = Gaussian(conf["structure"]["timesteps"], dev)
    s_err, s_ref, s_worst, s_read = 0.0, 0.0, 0.0, 0
    for kind, call, final, states, table in followed:
        if kind != "structure":
            continue
        replay = max(replay, compare.exact_gap(final, call["out"]))
        e2, r2, worst, read = compare.structure_steps(
            s_ctx, diff, call["batch"], states, table, call["draws"][1],
            ddim=serving["sampler"] == "ddim", eta=serving["ddim_eta"],
            max_gain=r.spec["max_gain"], device=dev)
        s_err, s_ref, s_read = s_err + e2, s_ref + r2, s_read + read
        s_worst = max(s_worst, worst)
    del s_ctx
    q_ctx = nets.Ctx(weights(conf, "sequence", r.seed_for("w.q"), dev),
                     conf["sequence"]["num_attention_heads"],
                     conf["sequence"]["max_seq_len"],
                     t_dtype=getattr(torch, _dtype(conf)))
    d3pm = D3PM(conf["sequence"]["timesteps"], dev)
    missed = seen = 0
    q_step = q_final = q_err = q_ref = 0.0
    for kind, call, final, states, extra in followed:
        if kind != "sequence":
            continue
        pairs, last_x = extra
        replay = max(replay, compare.exact_gap(final, call["out"]))
        m, n, a, b, e2, r2 = compare.sequence_steps(
            q_ctx, d3pm, call["batch"], states, pairs, call["draws"][1],
            last_x, final, dev)
        missed, seen, q_err, q_ref = missed + m, seen + n, q_err + e2, \
            q_ref + r2
        q_step, q_final = max(q_step, a), max(q_final, b)
    r.read("replay_gap", replay)
    r.read("struct_eps_rel", math.sqrt(s_err / s_ref) if s_read else math.inf)
    r.read("seq_logit_rel", math.sqrt(q_err / q_ref) if q_ref else math.inf)
    r.read("seq_draw_miss", missed / seen if seen else math.inf)
    print(f"serve check: {s_read} structure steps read (the worst step's "
          f"eps error {s_worst!r}); widest gap of a drawn class {q_step!r},"
          f" of a served token {q_final!r}; {len(designs)} designs tied",
          file=sys.stderr)


def _dtype(conf):
    return {"bf16": "bfloat16", "f32": "float32"}[conf["compute_dtype"]]
