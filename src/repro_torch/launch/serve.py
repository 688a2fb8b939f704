"""Serving CLI: batched speculative (or plain) decoding of synthetic
requests (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke --device cpu --speculative [--use-cache] [--placement DxT]

serves ``--requests`` synthetic prompts of ``--prompt-len`` tokens,
``--max-new`` new tokens each, wave by wave (``--batch`` requests per
wave), in the paper's no-cache mode or, with ``--use-cache``, on ring KV
caches (or the state caches of ``--arch mamba2-780m``); without
``--speculative`` it serves all requests as one autoregressive batch,
cached or not. It runs on the GPU unless ``--device cpu`` is given.

The CLI plans with ``repro_torch.api.Planner`` and executes through the
``Session`` facade, as the JAX CLI does: the planner's Eq. (1) decision
picks gamma from ``--alpha`` and ``--cost-coefficient`` (its prior c when
none is given; gamma* = 0 serves AR), ``--gamma`` forces the draft
length, and omitting ``--speculative`` forces AR. The printed
``alpha_hat`` is the session's acceptance moving average.
``--trace-out PATH`` traces the speculative serve (one ``generate`` span
per wave under ``--strategy monolithic``, draft/verify/commit spans per
round under ``modular``) and writes the Chrome trace to PATH.
``--placement DxT`` lowers a drafter-on-D, target-on-T placement and
prints it; with ``--use-cache`` the engine then runs placed rounds with
the lookahead dispatch (``1x1`` on one card: both roles on device 0), and
a plan the placed round cannot run keeps the unplaced path.

``serve()`` is the same path as a function: it plans the waves with gamma
pinned and runs them through ``Session.generate``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.api import DeploymentSpec, ExecutionPlan, Planner, Session
from repro_torch.core.engine import STRATEGIES
from repro_torch.launch import cli_args
from repro_torch.obs import clock
from repro_torch.sampling.keys import TorchKey


def serve_plan(batch, prompt_len, max_new, *, gamma=None, alpha=0.8,
               cost_coefficient=None, use_cache=False,
               strategy="monolithic", greedy=True,
               temperature=1.0) -> ExecutionPlan:
    """The plan of a serve: the Planner's for waves of ``batch`` uniform
    requests with a fixed (non-adaptive) gamma; ``gamma`` forces the draft
    length (0 = AR), None keeps the planner's Eq. (1) gamma*."""
    plan = Planner(DeploymentSpec(
        batch_size=batch, prompt_lens=(prompt_len,), max_new=max_new,
        alpha=alpha, cost_coefficient=cost_coefficient, adaptive_gamma=False,
        use_cache=use_cache, strategy=strategy, greedy=greedy,
        temperature=temperature)).plan()
    if gamma is None:
        return plan
    return dataclasses.replace(
        plan, gamma=dataclasses.replace(plan.gamma, gamma=gamma))


def serve_waves(sess: Session, prompts, max_new, batch, key=None):
    """Serve the [R, P] ``prompts`` through ``sess``, ``batch`` requests per
    wave, wave i with the i-th child of ``key`` (default ``TorchKey(0)``;
    sampled plans draw from it). Returns (tokens [R, P + max_new] numpy,
    stats)."""
    prompts = np.asarray(prompts, np.int32)
    R, P = prompts.shape
    waves = -(-R // batch)
    keys = (key if key is not None else TorchKey(0)).split(waves)
    out = np.zeros((R, P + max_new), np.int32)
    totals = {"rounds": 0, "accepted": 0, "drafted": 0}
    latencies = []
    t0 = clock.perf()
    for w, i in enumerate(range(0, R, batch)):
        wave = prompts[i:i + batch]
        toks, st = sess.generate(wave, max_new, key=keys[w])
        # the last round may commit past the budget: trim to it
        out[i:i + len(wave)] = toks[:, :P + max_new].cpu().numpy()
        for name in totals:
            totals[name] += st[name]
        latencies += [clock.perf() - t0] * len(wave)
    seconds = clock.perf() - t0
    stats = {**totals, "requests": R, "waves": waves,
             "gamma": sess.plan.gamma.gamma, "generated": R * max_new,
             "seconds": seconds, "tokens_per_s": R * max_new / seconds,
             "mean_latency_s": float(np.mean(latencies)),
             "alpha_hat": (totals["accepted"] / totals["drafted"]
                           if totals["drafted"] else None)}
    return out, stats


def serve(target, drafter, params_t, params_d, prompts, max_new, *, gamma,
          batch, strategy="monolithic", tracer=None, use_cache=False,
          greedy=True, temperature=1.0, key=None):
    """Serve the [R, P] ``prompts`` wave by wave, ``batch`` requests per
    wave, through a ``Session`` on ``serve_plan``'s plan with ``gamma``
    pinned (speculative rounds for gamma >= 1, traced by ``tracer``;
    autoregressive for gamma 0), no cache or cached with ``use_cache``, on
    the params' device. ``greedy=False`` samples at ``temperature``, wave i
    with the i-th child of ``key``. Returns (tokens [R, P + max_new] numpy,
    stats)."""
    prompts = np.asarray(prompts, np.int32)
    plan = serve_plan(batch, prompts.shape[1], max_new, gamma=gamma,
                      use_cache=use_cache, strategy=strategy, greedy=greedy,
                      temperature=temperature)
    sess = Session(target, drafter, params_t, params_d, plan,
                   max_batch=batch, tracer=tracer,
                   device=params_t["embed"]["table"].device)
    return serve_waves(sess, prompts, max_new, batch, key=key)


def main(argv=None):
    ap = argparse.ArgumentParser()
    cli_args.add_model_args(ap)
    cli_args.add_traffic_args(ap)
    cli_args.add_spec_args(ap)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--use-cache", action="store_true",
                    help="the cached engine (ring KV caches, or the ssm "
                         "state caches) instead of the paper's no-cache mode")
    ap.add_argument("--strategy", default="monolithic", choices=STRATEGIES)
    ap.add_argument("--batch", type=int, default=8)
    cli_args.add_trace_args(ap)
    args = ap.parse_args(argv)

    mt, md, pt, pd, cfg_t = cli_args.build_pair(args.arch, args.smoke,
                                                args.device)
    rng = np.random.default_rng(0)
    R, P, new = args.requests, args.prompt_len, args.max_new
    # CLI overrides trump the planner: --gamma forces the draft length and
    # omitting --speculative forces the AR path (gamma 0); with neither,
    # the planner's Eq. (1) decision stands
    plan = serve_plan(args.batch, P, new,
                      gamma=args.gamma if args.speculative else 0,
                      alpha=args.alpha, cost_coefficient=args.cost_coefficient,
                      use_cache=args.use_cache, strategy=args.strategy)
    plan = cli_args.apply_placement_arg(plan, args.placement)
    sess = Session(mt, md, pt, pd, plan, max_batch=args.batch,
                   tracer=cli_args.make_tracer(args), device=args.device)
    if args.placement:
        print(sess.placement.describe())
    if not args.speculative:
        # plain autoregressive serving baseline (one fixed batch)
        prompts = rng.integers(0, cfg_t.vocab_size, (R, P))
        toks, s = serve_waves(sess, prompts, new, batch=R)
        print(f"AR served {R} x {new} tokens in {s['seconds']:.2f}s "
              f"({R * new / s['seconds']:.1f} tok/s)")
        return toks, s

    prompts = np.stack([rng.integers(0, cfg_t.vocab_size, P)
                        for _ in range(R)])
    toks, s = serve_waves(sess, prompts, new, args.batch)
    alpha = sess.alpha_hat
    print(f"speculative served {R} requests, {s['generated']} tokens in "
          f"{s['seconds']:.2f}s ({s['tokens_per_s']:.1f} tok/s aggregate, "
          f"mean latency {s['mean_latency_s'] * 1e3:.0f}ms, "
          f"alpha_hat={float('nan') if alpha is None else alpha:.2f}, "
          f"gamma={plan.gamma.gamma}, strategy={plan.strategy}, "
          f"cache={args.use_cache}, backend={sess.backend_name})")
    cli_args.report_telemetry(sess, args)
    return toks, s


if __name__ == "__main__":
    main()
