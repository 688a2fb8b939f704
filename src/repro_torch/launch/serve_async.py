"""Async streaming serving CLI: open-loop replay against the paged server
(port of ``repro/launch/serve_async.py``).

    python -m repro_torch.launch.serve_async --arch llama3.2-3b [--smoke] [--device cpu]
        [--arrivals poisson|bursty] [--rate R] [--requests N] [--seed S]
        [--slo-base-s B --slo-per-token-s T] [--quiet]

replays a seeded Poisson (or bursty) arrival trace through
``Session.serve_async`` — the asyncio front end over the paged speculative
server — and streams every committed token to stdout as it lands, tagged
``rid@round`` so each token joins the obs layer's RoundEvent stream. It is
the open-system counterpart of ``launch/serve_paged.py`` (which drains a
closed request list): requests arrive WHILE earlier ones generate,
deadlines drive EDF admission, and the report after the run splits TTFT
into queue wait and service. It runs on the GPU unless ``--device cpu`` is
given. ``--trace-out`` writes the Chrome trace of the run's spans, whose
prefill/draft/verify/commit spans line up with the stream timestamps.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses

import numpy as np

from repro_torch.core.batched_engine import KV_FAMILIES
from repro_torch.launch import cli_args
from repro_torch.obs import clock


def _percentile(xs, q):
    xs = [x for x in xs if x is not None]
    return float(np.percentile(xs, q)) if xs else None


def build_session(args):
    from repro_torch.api import DeploymentSpec, Planner, Session
    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    spec = DeploymentSpec(
        batch_size=args.batch,
        prompt_lens=(4, 18), max_new=24,      # ragged traffic -> paged plan
        streaming=True, alpha=args.alpha,
        cost_coefficient=args.cost_coefficient,
        adaptive_gamma=args.gamma is None)
    plan = Planner(spec).plan()
    plan = dataclasses.replace(
        plan, batching="continuous",
        cache=dataclasses.replace(plan.cache, kind="paged",
                                  block_size=args.block_size,
                                  num_blocks=args.num_blocks,
                                  max_blocks_per_row=args.max_blocks_per_row),
        gamma=(plan.gamma if args.gamma is None else
               dataclasses.replace(plan.gamma, gamma=args.gamma)))
    plan = cli_args.apply_placement_arg(plan, args.placement)
    plan = cli_args.apply_prefill_args(plan, args)
    plan = cli_args.apply_overcommit_arg(plan, args.overcommit)
    sess = Session(mt, md, pt, pd, plan, max_batch=args.batch,
                   tracer=cli_args.make_tracer(args), device=args.device)
    if sess.backend_name != "paged":
        raise SystemExit(
            f"--arch {args.arch} (family {mt.family!r}) cannot take the "
            f"paged backend (KV-cache families only: "
            f"{', '.join(KV_FAMILIES)})")
    fault_plan = cli_args.make_fault_plan(args.faults_seed)
    if fault_plan is not None:
        sess.backend.server.inject_faults(fault_plan)
        print(f"chaos: {fault_plan.describe()}")
    return sess, cfg_t


async def replay_main(args, sess, cfg_t):
    from repro_torch.serving.frontend import bursty_trace, poisson_trace, replay
    make = bursty_trace if args.arrivals == "bursty" else poisson_trace
    trace = make(args.requests, args.rate, cfg_t.vocab_size, seed=args.seed,
                 slo_base_s=args.slo_base_s,
                 slo_per_token_s=args.slo_per_token_s)

    def on_token(rid, ev):
        if not args.quiet:
            print(f"  {rid}@{ev.round}: {ev.token}", flush=True)

    t0 = clock.wall()
    async with sess.serve_async() as front:
        records = await replay(front, trace, on_token=on_token)
    return records, clock.wall() - t0, front


def report(records, dt, front):
    n_tok = sum(r["n_tokens"] for r in records)
    ttfts = [r["ttft_s"] for r in records]
    tpots = [r["tpot_s"] for r in records]
    met = [r["deadline_met"] for r in records if r["deadline_met"] is not None]
    m = front.metrics.summary()
    print(f"replayed {len(records)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s aggregate, "
          f"rounds={front.server.total_rounds})")
    p50, p95 = _percentile(ttfts, 50), _percentile(ttfts, 95)
    print(f"TTFT p50={p50 * 1e3:.0f}ms p95={p95 * 1e3:.0f}ms   "
          f"TPOT p50={(_percentile(tpots, 50) or 0) * 1e3:.1f}ms"
          if p50 is not None else "TTFT: no tokens streamed")
    # TTFT decomposition: queue-wait (admission delay) vs service
    waits = [rec.queue_wait for rec in front.metrics.completed
             if rec.queue_wait is not None]
    if waits and p50 is not None:
        print(f"  of which queue-wait p50={_percentile(waits, 50) * 1e3:.0f}ms "
              f"p95={_percentile(waits, 95) * 1e3:.0f}ms "
              f"(rest = prefill + first round)")
    if met:
        print(f"goodput: {sum(met)}/{len(met)} deadlines met "
              f"({m['goodput']:.2f} of committed tokens within SLO)")
    depths = front.queue_depths()
    if depths:
        print(f"queue depth mean={np.mean(depths):.1f} max={max(depths)}")
    cli_args.report_prefill(front.server)
    cli_args.report_robustness(front.server)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli_args.add_model_args(ap)
    cli_args.add_spec_args(ap, gamma=None)
    cli_args.add_trace_args(ap)
    cli_args.add_robustness_args(ap)
    cli_args.add_prefill_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrivals", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="arrival rate (req/s; burst-window rate for bursty)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-base-s", type=float, default=None,
                    help="per-request deadline base (None = no deadlines)")
    ap.add_argument("--slo-per-token-s", type=float, default=0.0,
                    help="deadline slope per requested output token")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the live rid@round token stream")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--max-blocks-per-row", type=int, default=16)
    args = ap.parse_args(argv)

    sess, cfg_t = build_session(args)
    if args.placement:
        print(sess.placement.describe())
    records, dt, front = asyncio.run(replay_main(args, sess, cfg_t))
    report(records, dt, front)
    cli_args.report_telemetry(sess, args)
    return records, front


if __name__ == "__main__":
    main()
