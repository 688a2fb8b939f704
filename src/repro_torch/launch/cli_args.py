"""Shared CLI flag parsing and model-pair loading for the port's serving
CLIs (port of part of ``repro/launch/cli_args.py``)."""
from __future__ import annotations

import argparse
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
                    help="draft length (default: the cost-model decision)")
    ap.add_argument("--alpha", type=float, default=0.8,
                    help="expected acceptance rate fed to the gamma decision")
    ap.add_argument("--cost-coefficient", type=float, default=None,
                    help="c = t_draft/t_target fed to the gamma decision")
    return ap


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
