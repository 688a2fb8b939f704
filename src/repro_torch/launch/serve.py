"""Serving CLI: batched speculative (or plain) decoding of synthetic
requests in the paper's no-cache mode (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke --device cpu --speculative

serves ``--requests`` synthetic prompts of ``--prompt-len`` tokens,
``--max-new`` new tokens each, wave by wave (``--batch`` requests per wave)
on ``SpecEngine(use_cache=False)``; without ``--speculative`` it serves all
requests as one autoregressive batch. It runs on the GPU unless ``--device
cpu`` is given.

The JAX CLI asks the ``Planner`` for gamma. Until the API facade is
ported, this one takes the same Eq. (1) decision directly
(``choose_gamma``: gamma* over 0..8 at the given alpha and c, with the
planner's prior c = 0.25); gamma* = 0 serves AR, as the planner's plan
does, and ``--gamma`` forces the draft length. Its ``alpha_hat`` is the
run's accepted / drafted (the JAX CLI prints its gamma controller's
moving average, which comes with the facade). ``--use-cache`` raises until
the ring KV cache is ported.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.engine import (STRATEGIES, EngineConfig, SpecEngine,
                                     autoregressive_generate)
from repro_torch.launch import cli_args
from repro_torch.obs import clock

DEFAULT_COST_COEFFICIENT = 0.25   # the planner's prior c (api/planner.py)
GAMMA_MAX = 8                     # the planner's default gamma_max


def choose_gamma(alpha: float, cost_coefficient=None) -> int:
    """The planner's decision ④: Eq. (1) gamma* over 0..GAMMA_MAX
    (0 = speculation does not pay: serve AR)."""
    c = DEFAULT_COST_COEFFICIENT if cost_coefficient is None else cost_coefficient
    return cost_model.optimal_gamma(alpha, c, GAMMA_MAX)[0]


def serve(target, drafter, params_t, params_d, prompts, max_new, *, gamma,
          batch, strategy="monolithic"):
    """Serve the [R, P] ``prompts`` wave by wave, ``batch`` requests per
    wave: no-cache ``SpecEngine`` rounds for gamma >= 1, no-cache
    ``autoregressive_generate`` for gamma 0. Returns (tokens
    [R, P + max_new] numpy, stats)."""
    prompts = np.asarray(prompts, np.int32)
    R, P = prompts.shape
    eng = (SpecEngine(target, drafter, EngineConfig(gamma=gamma,
                                                    strategy=strategy))
           if gamma else None)
    out = np.zeros((R, P + max_new), np.int32)
    totals = {"rounds": 0, "accepted": 0, "drafted": 0}
    latencies = []
    t0 = clock.perf()
    for i in range(0, R, batch):
        wave = prompts[i:i + batch]
        if eng is None:
            toks = autoregressive_generate(target, params_t, wave, max_new)
            st = {"rounds": max_new, "accepted": 0, "drafted": 0}
        else:
            toks, st = eng.generate(params_t, params_d, wave, max_new)
        # the last round may commit past the budget: trim to it
        out[i:i + len(wave)] = toks[:, :P + max_new].cpu().numpy()
        for key in totals:
            totals[key] += st[key]
        latencies += [clock.perf() - t0] * len(wave)
    seconds = clock.perf() - t0
    stats = {**totals, "requests": R, "waves": -(-R // batch),
             "gamma": gamma, "generated": R * max_new, "seconds": seconds,
             "tokens_per_s": R * max_new / seconds,
             "mean_latency_s": float(np.mean(latencies)),
             "alpha_hat": (totals["accepted"] / totals["drafted"]
                           if totals["drafted"] else None)}
    return out, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    cli_args.add_model_args(ap)
    cli_args.add_traffic_args(ap)
    cli_args.add_spec_args(ap)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--use-cache", action="store_true",
                    help="cached engine (not ported yet: raises)")
    ap.add_argument("--strategy", default="monolithic", choices=STRATEGIES)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if args.use_cache:
        raise NotImplementedError(
            "--use-cache needs the ring KV cache, which a later slice ports")

    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    rng = np.random.default_rng(0)
    R, P, new = args.requests, args.prompt_len, args.max_new
    if not args.speculative:
        # plain autoregressive serving baseline (one fixed batch)
        prompts = rng.integers(0, cfg_t.vocab_size, (R, P))
        toks, s = serve(mt, md, pt, pd, prompts, new, gamma=0, batch=R)
        print(f"AR served {R} x {new} tokens in {s['seconds']:.2f}s "
              f"({R * new / s['seconds']:.1f} tok/s)")
        return toks, s

    gamma = (args.gamma if args.gamma is not None
             else choose_gamma(args.alpha, args.cost_coefficient))
    prompts = np.stack([rng.integers(0, cfg_t.vocab_size, P)
                        for _ in range(R)])
    toks, s = serve(mt, md, pt, pd, prompts, new, gamma=gamma,
                    batch=args.batch, strategy=args.strategy)
    alpha = s["alpha_hat"]
    print(f"speculative served {R} requests, {s['generated']} tokens in "
          f"{s['seconds']:.2f}s ({s['tokens_per_s']:.1f} tok/s aggregate, "
          f"mean latency {s['mean_latency_s'] * 1e3:.0f}ms, "
          f"alpha_hat={float('nan') if alpha is None else alpha:.2f}, "
          f"gamma={gamma}, strategy={args.strategy}, cache=False, "
          f"backend=engine)")
    return toks, s


if __name__ == "__main__":
    main()
