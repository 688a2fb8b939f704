"""Dry run of every (architecture x input shape) on meta tensors (port of
``repro/launch/dryrun.py``, without XLA).

  python -m repro_torch.launch.dryrun --all [--multi-pod] [--int8-w] [--int8-kv]

For each pair it builds the step ``launch.steps`` would run (train,
prefill or decode) with ``meta`` inputs, so no weight, cache or
optimizer state is allocated and no device is needed, and records: the
bytes of the step's arguments one device of the mesh holds under JAX's
shardings (``arg_share``: each leaf's bytes over the product of the axis
sizes its spec names, the specs from ``models/specs.py``'s builders as
JAX's step builders take them), and the analytic roofline
terms JAX's dry run computes (``core.analytic_cost.step_cost`` and
``cost_model.roofline_terms`` at JAX's arguments, on the port's
``DEFAULT_HW``, the H100). The mesh is the one JAX would build, 16 x 16
chips (2 x 16 x 16 with ``--multi-pod``), given as its axis sizes: the
policy booleans (fsdp, expert_2d, serve_2d) and the cost's chip and data
counts come from it as in JAX (the record's ``policy``); no mesh is
built.

Deliberate differences from JAX's dry run:

  * The records that come from XLA are left out, with
    ``launch/hlo_analysis.py``: ``hlo_*_raw``, ``collectives``, the temp
    and output bytes, ``lower_s`` and ``compile_s``. ``launch/mesh.py`` is
    left out too (no mesh is built).
  * Results go to the port's own ``dryrun_results_torch.json`` at the repo
    root, never to JAX's ``dryrun_results.json`` (which
    ``benchmarks/roofline.py`` reads). As in JAX, ``--all`` sweeps every
    registry arch but ``llama3.2-3b``.
"""
from __future__ import annotations

import argparse
import json
import math
import traceback
from pathlib import Path

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import analytic_cost, cost_model
from repro_torch.launch import steps
from repro_torch.models import specs
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop

RESULTS = Path(__file__).resolve().parents[3] / "dryrun_results_torch.json"

# documented skips (DESIGN.md §Shape coverage)
SKIPS = {("whisper-large-v3", "long_500k"):
         "enc-dec with a 448-token decoder horizon has no meaningful 524k decode"}

LONG_SWA_WINDOW = 8192   # sliding-window variant for dense/vlm at long_500k


def mesh_axis_sizes(multi_pod: bool = False) -> dict:
    """The axis sizes of JAX's production mesh: 16 x 16 = 256 chips a pod;
    multi-pod prepends a 2-pod axis (512 chips)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def microbatches_for(cfg, shape) -> int:
    n = cfg.param_count()
    if n > 1e11:
        return 32
    if n > 2e10:
        return 16
    if n > 3e9:
        return 4
    return 1


def needs_fsdp(cfg, m_size) -> bool:
    """fsdp costs per-microbatch weight regathers; only pay when the fp32
    param+moment state cannot fit with model-axis sharding alone."""
    return cfg.param_count() * 12 / max(m_size, 1) > 8e9


def needs_serve_fsdp(cfg, m_size) -> bool:
    """Weight-gathered serving (ZeRO-inference) when bf16 params exceed the
    HBM budget under model-axis sharding alone (llama3-405b)."""
    return cfg.param_count() * 2 / max(m_size, 1) > 10e9


def optimizer_for(cfg):
    """>=100B-param models use factored second moments (Adafactor): AdamW's
    2x fp32 moments exceed a pod's memory at 405B."""
    if cfg.param_count() > 1e11:
        return opt.AdafactorConfig()
    return opt.AdamWConfig()


def arch_config(arch: str, shape_name: str, variant=None):
    variant = variant or {}
    cfg = registry.config(arch)
    shape = INPUT_SHAPES[shape_name]
    note = ""
    if shape.kind == "train":
        cfg = cfg.replace(remat=True, param_dtype="float32",
                          remat_policy=("dots" if variant.get("remat_dots")
                                        else "full"))
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm") \
            and cfg.sliding_window is None:
        cfg = cfg.replace(sliding_window=LONG_SWA_WINDOW,
                          name=cfg.name + "-swa8k")
        note = f"sliding-window({LONG_SWA_WINDOW}) variant for sub-quadratic long decode"
    return cfg, shape, note


def build(model, shape, cfg, quantized=False, cache_int8=False):
    if shape.kind == "train":
        return steps.build_train_step(model, shape,
                                      num_microbatches=microbatches_for(cfg, shape),
                                      ocfg=optimizer_for(cfg))
    if shape.kind == "prefill":
        return steps.build_prefill_step(model, shape, quantized=quantized,
                                        cache_int8=cache_int8)
    return steps.build_decode_step(model, shape, quantized=quantized,
                                   cache_int8=cache_int8)


def _share(leaf, spec, pol) -> int:
    """Bytes of one device's piece of ``leaf`` under ``spec``."""
    return (math.prod(specs.local_shape(leaf.shape, spec, pol))
            * leaf.element_size())


def _tree_share(tree, spec_tree, pol) -> int:
    total = []
    specs.zip_with_path(
        lambda _, spec, leaf: total.append(_share(leaf, spec, pol)),
        spec_tree, tree)
    return sum(total)


def _batch_specs(tree, b_ax, bdim=0):
    """Specs with the batch axis on dim ``bdim`` of every leaf (JAX's
    ``extras_specs`` and the encoder-decoder's cross K/V)."""
    def one(_, leaf):
        spec = [None] * leaf.dim()
        spec[bdim] = b_ax
        return tuple(spec)
    return specs.map_with_path(one, tree)


def _opt_share(model, params, state, pspecs, pol) -> int:
    """One device's bytes of the optimizer state, by the rule of JAX's
    ``train_loop.opt_state_specs``: AdamW's moments take their params'
    specs; Adafactor's statistics of a (stacked) leaf of spec ``ps`` take
    ``ps[:-1]`` (row) and ``ps[:-2] + ps[-1:]`` (column), and a leaf of
    rank < 2 keeps ``ps``; the 1-element placeholders are replicated. The
    step count is 4 bytes (a host int in the port; JAX passes an int32).
    A ring's ``positions`` is its layout, not an argument of JAX's."""
    if isinstance(state, opt.OptState):
        return 4 + _tree_share(state.mu, pspecs, pol) + \
            _tree_share(state.nu, pspecs, pol)
    total = 4
    for group in opt.layout(model.cfg, train_loop.trainable(params)):
        ps = (((None,) if group.stacked else ())
              + tuple(opt.get(pspecs, group.paths[0])))
        rank = len(ps)
        vr = ps[:-1] if rank >= 2 else (None,)
        vc = ps[:-2] + ps[-1:] if rank >= 2 else (None,)
        v = ps if rank < 2 else (None,)
        for stats, spec in ((state.vr, vr), (state.vc, vc), (state.v, v)):
            total += _share(stats[group.name], spec, pol)
    return total


def arg_share(model, kind, inputs, pol) -> int:
    """Bytes of a step's arguments on one device of the mesh ``pol``
    describes: params by ``param_specs``, caches by ``cache_specs``,
    tokens (and a train batch's labels) by ``io_specs``, modality extras
    with the batch axis on their batch dim, the optimizer state by
    ``_opt_share``."""
    cfg = model.cfg
    params = inputs["params"]
    pspecs = specs.param_specs(cfg, params, pol)
    total = _tree_share(params, pspecs, pol)
    if kind == "train":
        batch = inputs["batch"]
        B = batch["tokens"].shape[0]
        tok, _ = specs.io_specs(pol, B)
        b_ax = pol.batch_axis(B)
        total += sum(_share(batch[k], tok, pol) for k in ("tokens", "labels"))
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        total += _tree_share(extras, _batch_specs(extras, b_ax), pol)
        return total + _opt_share(model, params, inputs["opt_state"], pspecs, pol)
    tokens = inputs["tokens"]
    B = tokens.shape[0]
    tok, _ = specs.io_specs(pol, B)
    b_ax = pol.batch_axis(B)
    total += _share(tokens, tok, pol)
    cache = inputs["cache"]
    total += _tree_share(cache, specs.cache_specs(cfg, cache, pol, B), pol)
    extras = inputs["extras"]
    bdim = 1 if "cross" in extras else 0     # cross K/V: [L, B, T, Kv, D]
    return total + _tree_share(extras, _batch_specs(extras, b_ax, bdim), pol)


def policy_for(cfg, shape, multi_pod: bool, variant=None) -> specs.ShardingPolicy:
    """The ``ShardingPolicy`` JAX's ``run_one`` builds for this pair on its
    production mesh."""
    variant = variant or {}
    sizes = mesh_axis_sizes(multi_pod)
    m_size = sizes.get("model", 1)
    fsdp = (needs_fsdp(cfg, m_size) if shape.kind == "train"
            else needs_serve_fsdp(cfg, m_size))
    expert_2d = (cfg.family == "moe"
                 and cfg.param_count() * 2 / m_size > 10e9)
    serve_2d = bool(variant.get("serve_2d")) and shape.kind != "train"
    return specs.ShardingPolicy(
        data=("pod", "data") if multi_pod else "data", model="model",
        fsdp=fsdp, expert_2d=expert_2d, replicate_batch=serve_2d,
        mesh_axis_sizes=sizes)


def run_one(arch: str, shape_name: str, multi_pod: bool, verbose=True,
            variant=None):
    variant = variant or {}
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    cfg, shape, note = arch_config(arch, shape_name, variant)
    sizes = mesh_axis_sizes(multi_pod)
    pol = policy_for(cfg, shape, multi_pod, variant)
    fsdp, expert_2d = pol.fsdp, pol.expert_2d
    serve_2d = pol.replicate_batch
    model = build_model(cfg)
    _, inputs = build(model, shape, cfg, quantized=bool(variant.get("int8_w")),
                      cache_int8=bool(variant.get("int8_kv")))
    arg = arg_share(model, shape.kind, inputs, pol)
    chips = 1
    for n in sizes.values():
        chips *= n
    nmb = microbatches_for(cfg, shape) if shape.kind == "train" else 1
    acost = analytic_cost.step_cost(
        cfg, shape, chips=chips, fsdp=fsdp, num_microbatches=nmb,
        data_size=sizes.get("data", 1) * sizes.get("pod", 1),
        w_bytes=(1 if variant.get("int8_w") and shape.kind != "train" else None),
        cache_elem_bytes=(1 if variant.get("int8_kv") else 2),
        weight_gather=(fsdp and shape.kind != "train"
                       and not variant.get("serve_2d")))
    trips = analytic_cost.scan_trips(cfg, shape.kind, nmb)
    terms = cost_model.roofline_terms(acost.flops, acost.hbm_bytes,
                                      acost.collective_bytes, chips)
    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * n_tok
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "note": note, "kind": shape.kind,
        "chips": chips,
        "policy": {"fsdp": fsdp, "expert_2d": expert_2d, "serve_2d": serve_2d},
        "params": cfg.param_count(), "active_params": n_active,
        "flops": acost.flops, "hbm_bytes": acost.hbm_bytes,
        "collective_bytes": acost.collective_bytes,
        "scan_trips": trips,
        "per_device_arg_bytes": arg,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "model_flops": model_flops,
        "useful_flop_frac": model_flops / acost.flops if acost.flops else 0.0,
    }
    if verbose:
        print(f"== {arch} x {shape_name} (multi_pod={multi_pod}, chips={chips}) {note}")
        print(f"   arguments: {arg / 1e9:.2f}GB a device")
        print(f"   analytic (global): flops={acost.flops:.3e} "
              f"bytes={acost.hbm_bytes:.3e} coll={acost.collective_bytes:.3e} "
              f"trips={trips}")
        print(f"   roofline: compute={terms.compute_s*1e3:.2f}ms "
              f"memory={terms.memory_s*1e3:.2f}ms "
              f"collective={terms.collective_s*1e3:.2f}ms -> {terms.dominant}-bound; "
              f"useful-FLOP frac={rec['useful_flop_frac']:.2f}")
    return rec


def load_results():
    if RESULTS.exists():
        return json.loads(RESULTS.read_text())
    return {}


def save_result(rec, tag=""):
    res = load_results()
    key = f"{rec['arch']}|{rec['shape']}|{'mp' if rec['multi_pod'] else 'sp'}|{tag}"
    res[key] = rec
    RESULTS.write_text(json.dumps(res, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="", help="results key suffix (perf variants)")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--int8-w", action="store_true", help="int8 serving weights")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV cache")
    ap.add_argument("--serve-2d", action="store_true",
                    help="replicate batch; shard weights+cache over both axes")
    ap.add_argument("--remat-dots", action="store_true",
                    help="remat policy: save MXU outputs instead of full recompute")
    args = ap.parse_args(argv)
    variant = {"int8_w": args.int8_w, "int8_kv": args.int8_kv,
               "serve_2d": args.serve_2d, "remat_dots": args.remat_dots}

    archs = [a for a in registry.ARCHS if a != "llama3.2-3b"] if args.all or not args.arch \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape else [args.shape]
    done = load_results() if args.skip_done else {}
    failures = []
    for arch in archs:
        for shape in shapes:
            key = f"{arch}|{shape}|{'mp' if args.multi_pod else 'sp'}|{args.tag}"
            if key in done and done[key].get("status") in ("ok", "skipped"):
                continue
            try:
                rec = run_one(arch, shape, args.multi_pod, variant=variant)
                save_result(rec, args.tag)
                if rec["status"] == "skipped":
                    print(f"== {arch} x {shape}: SKIPPED ({rec['reason']})")
            except Exception as e:  # record failure, keep sweeping
                print(f"== {arch} x {shape}: FAILED {e}")
                traceback.print_exc()
                failures.append((arch, shape, str(e)))
                save_result({"arch": arch, "shape": shape,
                             "multi_pod": args.multi_pod, "status": "failed",
                             "error": str(e)[:2000]}, args.tag)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS OK")


if __name__ == "__main__":
    main()
