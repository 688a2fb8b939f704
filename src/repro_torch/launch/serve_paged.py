"""Paged serving CLI: ragged variable-length speculative serving
(port of ``repro/launch/serve_paged.py``).

    python -m repro_torch.launch.serve_paged --arch llama3.2-3b [--smoke] [--device cpu]
        [--prefill-chunk N] [--prefix-cache] [--overcommit F]
        [--placement DxT] [--faults-seed S]

serves a stream of synthetic requests with mixed prompt lengths and
per-request decode budgets on the paged speculative server. It runs on the
GPU unless ``--device cpu`` is given. The CLI plans with
``repro_torch.api.Planner`` (streaming ragged traffic: continuous batching
on the paged block pool) and executes through the ``Session`` facade, as
the JAX CLI does. The flags trump the planner's sizing: the block geometry
(``--batch``, ``--block-size``, ``--num-blocks``,
``--max-blocks-per-row``), chunked prefill (``--prefill-chunk N``: at most
N prompt tokens between two rounds), the prefix pool (``--prefix-cache``:
requests sharing a prompt prefix attach its cached KV blocks; implies
chunked prefill) and overcommitted admission (``--overcommit F`` > 1:
admit on expected demand and preempt when the pool runs dry; on the
bucketed path the buckets grow to cover a resumed prefix). The plan's
adaptive gamma hands the gamma/AR decision to the scheduler's online cost
model unless ``--gamma`` pins gamma. ``--trace-out PATH`` traces the run
(draft/verify/commit/prefill/serve spans) and writes the Chrome trace to
PATH; the drift monitor's measured c then drives the gamma decision. After
the run it prints the prefill counters, when any occurred the
preemptions and degradations, and with ``--trace-out`` the phase
breakdown, drift alerts and the measured c. ``--placement DxT`` lowers a
drafter-on-D, target-on-T placement (``1x1`` on one card: both roles on
device 0) and prints it; ``--faults-seed S`` injects
``FaultPlan.seeded(S)`` (virtual delays, drafter failures, pool seizures;
the batch degrades to AR and the tokens stay the clean run's) and prints
it.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.api import DeploymentSpec, Planner, Session
from repro_torch.launch import cli_args
from repro_torch.obs import clock
from repro_torch.serving import ServeRequest


def synthetic_requests(rng, n, vocab, prompt_lens=(4, 18), max_news=(4, 24)):
    reqs = []
    for i in range(n):
        P = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        new = int(rng.integers(max_news[0], max_news[1] + 1))
        reqs.append(ServeRequest(i, rng.integers(0, vocab, P).astype(np.int32),
                                 new))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    cli_args.add_model_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    cli_args.add_spec_args(ap)
    cli_args.add_trace_args(ap)
    cli_args.add_robustness_args(ap)
    cli_args.add_prefill_args(ap)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--max-blocks-per-row", type=int, default=16)
    args = ap.parse_args(argv)

    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    rng = np.random.default_rng(0)
    reqs = synthetic_requests(rng, args.requests, cfg_t.vocab_size)

    spec = DeploymentSpec(
        batch_size=args.batch,
        prompt_lens=tuple(r.prompt_len for r in reqs),
        max_new=tuple(r.max_new for r in reqs),
        streaming=True, alpha=args.alpha,
        cost_coefficient=args.cost_coefficient,
        adaptive_gamma=args.gamma is None)
    plan = Planner(spec).plan()
    # CLI block geometry trumps the planner's sizing; --gamma forces a fixed
    # draft length (adaptive_gamma=False above disables the online decision)
    plan = dataclasses.replace(
        plan, batching="continuous",       # paged even if the sample traffic
        cache=dataclasses.replace(plan.cache, kind="paged",  # looked uniform
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
    if args.placement:
        print(sess.placement.describe())
    if sess.backend_name != "paged":
        raise SystemExit(
            f"--arch {args.arch} (family {mt.family!r}) cannot take the paged "
            f"backend (KV-cache families only) — use repro_torch.launch.serve")
    fault_plan = cli_args.make_fault_plan(args.faults_seed)
    if fault_plan is not None:
        sess.backend.server.inject_faults(fault_plan)
        print(f"chaos: {fault_plan.describe()}")

    t0 = clock.wall()
    done = sess.serve(reqs)
    dt = clock.wall() - t0
    srv = sess.backend.server
    s = srv.metrics.summary()
    total = s["total_generated_tokens"]
    alpha = s["alpha_hat"]
    print(f"paged-served {len(done)} ragged requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s aggregate, "
          f"mean latency {s['mean_latency_s'] * 1e3:.0f}ms, "
          f"gamma={srv.gamma} [{'forced' if args.gamma is not None else 'cost-model'}], "
          f"rounds={srv.total_rounds}, "
          f"alpha_hat={alpha if alpha is None else round(alpha, 2)})")
    print(f"acceptance histogram (n_accepted per round): "
          f"{s['accept_hist'][:(srv.gamma or 0) + 1].tolist()}")
    cli_args.report_prefill(srv)
    cli_args.report_robustness(srv)
    cli_args.report_telemetry(sess, args)
    return srv


if __name__ == "__main__":
    main()
