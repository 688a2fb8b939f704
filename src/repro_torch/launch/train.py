"""Training entry point: ``python -m repro_torch.launch.train --arch <id>
[--smoke] ...`` (port of ``repro/launch/train.py``).

Synthetic Markov data (``data.pipeline``), AdamW with JAX's warmup and
cosine schedule, checkpointing (``checkpoint.ckpt``); it prints JAX's
lines. It runs on the card (``--device`` defaults to cuda, where the
no-cache attention trains through the flash kernels) or, when asked, on
the CPU: ``--smoke --device cpu`` trains a reduced config end to end. The
trained-pair recipe (a target and a drafter on one order-1 stream, so that
the acceptance rate is learned) calls ``train`` with ``data_order=1``.
JAX's ``mesh`` argument has no counterpart: the step runs on one device.
Time is read only through ``obs.clock``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as devices
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.models.model import build_model
from repro_torch.obs import clock
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop


def train(cfg, *, steps_n=200, batch=8, seq=64, lr=1e-3, seed=0,
          ckpt_path=None, log_every=20, data_seed=0, data_order=2,
          device=None):
    """Train ``cfg`` from the seeded init for ``steps_n`` steps; returns
    (params, per-step losses). The params hold no ``table_f32``
    (``train_loop.serving_params`` adds it for serving)."""
    dev = devices.resolve(device)
    model = build_model(cfg)
    params = train_loop.trainable(model.init(seed, dev))
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=max(10, steps_n // 20),
                           total_steps=steps_n)
    opt_state = train_loop.init_opt_state(model, ocfg, params)

    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=data_seed,
                               order=data_order)
    stream = pipeline.batches(dcfg)
    step_fn = train_loop.make_train_step(model, ocfg)

    extras = {k: torch.full(shape, 0.1, dtype=dt, device=dev)
              for k, (shape, dt) in model.extra_inputs(batch).items()}
    t0 = clock.wall()
    losses = []
    for i in range(steps_n):
        tokens, labels = pipeline.split_batch(next(stream))
        b = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev), **extras}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps_n - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(clock.wall()-t0)/(i+1):.2f}s/step)", flush=True)
    if ckpt_path:
        ckpt.save(ckpt_path, params, step=steps_n)
        print(f"saved {ckpt_path}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--drafter", action="store_true", help="train the drafter config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass 'cpu' to train "
                         "on the CPU)")
    args = ap.parse_args(argv)

    mod = registry.get(args.arch)
    if args.smoke:
        cfg = mod.smoke_config()
        if args.drafter:
            cfg = cfg.replace(num_layers=max(1, cfg.num_layers - 1),
                              d_model=max(64, cfg.d_model // 2),
                              num_heads=max(1, cfg.num_heads // 2),
                              num_kv_heads=max(1, cfg.num_kv_heads // 2),
                              d_ff=max(64, cfg.d_ff // 2),
                              name=cfg.name + "-draft")
    else:
        cfg = mod.drafter_config() if args.drafter else mod.config()
    print(f"training {cfg.name} ({cfg.family}) params~{cfg.param_count():,}")
    return train(cfg, steps_n=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt_path=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
