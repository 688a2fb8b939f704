"""Paged serving CLI: ragged variable-length speculative serving
(port of ``repro/launch/serve_paged.py``).

    python -m repro_torch.launch.serve_paged --arch llama3.2-3b [--smoke] [--device cpu]

serves a stream of synthetic requests with mixed prompt lengths and
per-request decode budgets on the paged speculative server. It runs on the
GPU unless ``--device cpu`` is given. The JAX CLI plans through the
``Planner``/``Session`` facade; until that is ported this one builds the
``SchedulerConfig`` directly from the block-geometry flags, and the
scheduler's online cost-model gamma/AR decision runs unless ``--gamma``
pins gamma.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch import cli_args
from repro_torch.obs import clock
from repro_torch.serving import PagedSpecServer, SchedulerConfig, ServeRequest


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
    ap.add_argument("--gamma", type=int, default=None,
                    help="draft length (default: the cost-model decision)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--max-blocks-per-row", type=int, default=16)
    args = ap.parse_args(argv)

    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    rng = np.random.default_rng(0)
    reqs = synthetic_requests(rng, args.requests, cfg_t.vocab_size)
    scfg = SchedulerConfig(max_batch=args.batch, block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           max_blocks_per_row=args.max_blocks_per_row)
    srv = PagedSpecServer(mt, md, pt, pd, scfg, gamma=args.gamma,
                          device=args.device)
    for r in reqs:
        srv.submit(r)

    t0 = clock.wall()
    done = srv.run()
    dt = clock.wall() - t0
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


if __name__ == "__main__":
    main()
