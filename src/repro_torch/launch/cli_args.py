"""Shared CLI flag parsing and model-pair loading for the port's serving
CLIs (port of part of ``repro/launch/cli_args.py``)."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

from repro_torch import device as devices


def add_model_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--arch", required=True,
                    help="configs.registry architecture id")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced CPU-sized configs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass 'cpu' to run the "
                         "plain PyTorch path on the CPU)")
    return ap


def add_traffic_args(ap: argparse.ArgumentParser, *, requests: int = 8,
                     prompt_len: int = 8, max_new: int = 24
                     ) -> argparse.ArgumentParser:
    ap.add_argument("--requests", type=int, default=requests)
    ap.add_argument("--prompt-len", type=int, default=prompt_len)
    ap.add_argument("--max-new", type=int, default=max_new)
    return ap


def add_spec_args(ap: argparse.ArgumentParser, *, gamma: int = None
                  ) -> argparse.ArgumentParser:
    """The JAX CLI's speculation flags, less ``--placement`` (placement is
    not ported)."""
    ap.add_argument("--gamma", type=int, default=gamma,
                    help="draft length (default: the planner's cost-model "
                         "decision)")
    ap.add_argument("--alpha", type=float, default=0.8,
                    help="expected acceptance rate fed to the planner")
    ap.add_argument("--cost-coefficient", type=float, default=None,
                    help="c = t_draft/t_target fed to the gamma decision")
    return ap


def add_robustness_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX CLI's ``--overcommit`` (``--faults-seed`` waits for the
    fault plan)."""
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="admission reservation divisor (>1.0 admits on "
                         "expected demand instead of the worst case; a dry "
                         "pool before a round evicts the most-slack row, "
                         "which re-prefills its committed prefix when it is "
                         "admitted again)")
    return ap


def add_prefill_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                    help="chunked prefill: at most N prompt tokens per "
                         "chunk, one chunk between two decode rounds "
                         "(instead of bucketed all-at-once prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cache prompt-prefix KV blocks and attach them to "
                         "later requests with the same prefix (implies "
                         "chunked prefill of the unique suffix)")
    return ap


def apply_prefill_args(plan, args):
    """Fold ``--prefill-chunk``/``--prefix-cache`` into the plan's cache
    layout (paged plans only; a no-op when neither flag is set)."""
    chunk = getattr(args, "prefill_chunk", None)
    prefix = bool(getattr(args, "prefix_cache", False))
    if chunk is None and not prefix:
        return plan
    return dataclasses.replace(plan, cache=dataclasses.replace(
        plan.cache, prefill_chunk=chunk, prefix_cache=prefix))


def apply_overcommit_arg(plan, overcommit):
    """Fold ``--overcommit`` into the plan's cache layout. With bucketed
    prefill, overcommitted admission must be able to re-prefill a preempted
    request's committed prefix (up to prompt + max_new - 1 tokens), so the
    buckets are extended by doubling until they cover it, as the planner
    does when IT decides to overcommit (api/planner.py). Chunked-prefill
    plans skip the extension: any resume length is a sequence of chunks."""
    if overcommit is None or overcommit <= 1.0:
        return plan
    cache = dataclasses.replace(plan.cache, overcommit=float(overcommit))
    if cache.prefill_chunk is None and not cache.prefix_cache:
        buckets = list(cache.prefill_buckets)
        resume_max = buckets[-1] + plan.max_new - 1
        while buckets[-1] < resume_max:
            buckets.append(buckets[-1] * 2)
        cache = dataclasses.replace(cache, prefill_buckets=tuple(buckets))
    return dataclasses.replace(plan, cache=cache)


def report_robustness(server):
    """Post-run preemption/expiry/failure counters, printed only when
    something happened."""
    s = server.metrics.summary()
    if (s["n_preemptions"] or s["requests_cancelled"]
            or s["requests_expired"] or s["requests_failed"]):
        print(f"robustness: preemptions={s['n_preemptions']} "
              f"(recompute_tokens={s['recompute_tokens']}), "
              f"cancelled={s['requests_cancelled']}, "
              f"expired={s['requests_expired']}, "
              f"failed={s['requests_failed']}")


def report_prefill(server):
    """Post-run chunked-prefill / prefix-cache counters, printed only when
    the run recorded prefill work."""
    s = server.metrics.summary()
    if not (s["prefill_tokens"] or s["prefix_hit_tokens"]):
        return
    line = (f"prefill: {s['prefill_tokens']} tokens computed, "
            f"{s['prefix_hit_tokens']} attached from prefix cache")
    if s["prefix_hit_rate"] is not None:
        line += (f" (hit-rate {s['prefix_hit_rate']:.0%}, prefill compute "
                 f"saved {s['prefill_compute_saved']:.0%})")
    if s["chunks_per_prefill"]:
        line += f", {s['chunks_per_prefill']:.1f} chunks/prefill"
    print(line)


def add_trace_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable round-phase tracing (repro_torch.obs) and "
                         "write a Chrome-trace/Perfetto JSON of the run's "
                         "draft/verify/commit spans to PATH. Tracing "
                         "synchronizes the device after each phase, so "
                         "expect lower throughput than the untraced round.")
    return ap


def make_tracer(args):
    """Tracer from ``--trace-out``: enabled iff a path was given (disabled
    tracing is free)."""
    from repro_torch.obs import Tracer
    return Tracer(enabled=args.trace_out is not None)


def report_telemetry(sess, args):
    """Post-run telemetry of a ``Session``: export the Chrome trace, print
    the per-phase breakdown and, on the paged backend, any cost-model drift
    alerts and the measured c. No-op when tracing is off."""
    tel = sess.telemetry()
    tracer = tel["tracer"]
    if args.trace_out and tracer.enabled:
        tracer.export(args.trace_out)
        totals = tracer.phase_totals()
        breakdown = ", ".join(f"{k}={v * 1e3:.0f}ms"
                              for k, v in sorted(totals.items()))
        print(f"trace: {tracer.count()} spans -> {args.trace_out} "
              f"({breakdown})")
    drift = tel.get("drift")
    if drift is not None and drift.calibrated:
        for msg in drift.alerts():
            print(f"drift: {msg}")
        ev = drift.evidence()
        if ev:
            print(f"drift: measured c={ev['c']:.3f} "
                  f"(t_draft={ev['t_draft'] * 1e3:.2f}ms/token, "
                  f"t_target={ev['t_target'] * 1e3:.2f}ms)")


def build_pair(arch: str, smoke: bool, device=None
               ) -> Tuple[object, object, dict, dict, object]:
    """(target, drafter, params_t, params_d, cfg_t) for a registry arch,
    with seeded random weights on ``device``.

    Smoke mode derives the drafter by shrinking the target one layer; full
    mode uses the registered drafter config (for ``llama3.2-3b``, the
    paper's Llama-3.2-1B drafter, both bf16). The target is seeded with 0
    and the drafter with 7, as in the JAX CLIs (the numbers differ:
    torch and jax generators differ)."""
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    dev = devices.resolve(device)
    mod = registry.get(arch)
    cfg_t = mod.smoke_config() if smoke else mod.config()
    cfg_d = (cfg_t.replace(num_layers=max(1, cfg_t.num_layers - 1), name="draft")
             if smoke else mod.drafter_config())
    mt, md = build_model(cfg_t), build_model(cfg_d)
    return mt, md, mt.init(0, dev), md.init(7, dev), cfg_t
