"""Exact analytic FLOPs / HBM-bytes / collective-bytes per (config, shape,
kind) (port of ``repro/core/analytic_cost.py``).

WHY THIS EXISTS: the planner prices a model without running it. Its
roofline (``cost_model.roofline_terms``) needs a step's work, and this
module counts it from first principles: matmul FLOPs from the parameter
count, attention and SSD FLOPs from the shapes, the weights and caches a
step streams, and the collectives a tensor-parallel layout would issue.

All quantities are GLOBAL (whole step, all devices); divide by chips for
per-device. Collective bytes model the reference's baseline layout:
  * tensor-parallel: 2 activation all-reduces per transformer layer (attn.o,
    mlp.down), bf16, forward; x3 for the backward pass in training. They
    are counted at ``chips=1`` too, as the reference counts them.
  * fsdp / weight-gathered serving: one param all-gather per step
    (x microbatches when the grad-accumulation loop re-gathers)
  * MoE expert parallelism: dispatch+combine all-to-alls, 2 x tokens x d x k
  * data-parallel training: gradient reduce-scatter+all-gather (= 2x params)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2
FP32 = 4


@dataclass
class StepCost:
    flops: float
    hbm_bytes: float
    collective_bytes: float

    def scaled(self, k: float) -> "StepCost":
        return StepCost(self.flops * k, self.hbm_bytes * k, self.collective_bytes * k)


def _attn_flops(cfg: ModelConfig, B: int, q_len: int, kv_len: int,
                n_layers: int = None) -> float:
    """QK^T + AV for GQA attention (softmax etc. negligible)."""
    if cfg.family == "ssm":
        return 0.0
    L = cfg.num_layers if n_layers is None else n_layers
    if cfg.family == "hybrid":
        L = sum(1 for i in range(cfg.num_layers) if cfg._block_kind(i) == "attn")
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.sliding_window is not None:
        kv_len = min(kv_len, cfg.sliding_window)
    if cfg.family == "hybrid":
        kv_len = min(kv_len, cfg.local_window)
    # causal prefill averages ~kv_len/2 visible positions
    eff = kv_len / 2 if q_len == kv_len else kv_len
    return L * 4.0 * B * q_len * eff * H * hd


def _ssm_flops(cfg: ModelConfig, B: int, q_len: int) -> float:
    """SSD state update + output per token: ~6*H*P*N flops/token/layer."""
    if cfg.family not in ("ssm",):
        return 0.0
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return cfg.num_layers * 6.0 * B * q_len * H * P * N


def _logits_flops(cfg: ModelConfig, B: int, positions: int) -> float:
    return 2.0 * B * positions * cfg.d_model * cfg.vocab_size


def _cache_bytes(cfg: ModelConfig, B: int, kv_len: int, write_len: int) -> float:
    """Read whole live cache + write new tokens, bf16."""
    if cfg.family == "ssm":
        state = cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        return 2.0 * state * BF16  # read + write
    win = kv_len
    if cfg.sliding_window is not None:
        win = min(win, cfg.sliding_window)
    if cfg.family == "hybrid":
        n_attn = sum(1 for i in range(cfg.num_layers) if cfg._block_kind(i) == "attn")
        n_rec = cfg.num_layers - n_attn
        kv = n_attn * B * min(kv_len, cfg.local_window) * cfg.num_kv_heads * cfg.head_dim * 2
        rec = n_rec * B * (cfg.lru_width or cfg.d_model) * 2
        return (kv + rec) * BF16 * 1.5
    L = cfg.num_layers
    kv = L * B * win * cfg.num_kv_heads * cfg.head_dim * 2  # k and v
    return (kv + L * B * write_len * cfg.num_kv_heads * cfg.head_dim * 2) * BF16


def _tp_collectives(cfg: ModelConfig, B: int, q_len: int, train: bool) -> float:
    """2 bf16 activation all-reduces per layer (Megatron TP), x3 for bwd."""
    L = cfg.num_layers + (cfg.num_encoder_layers if cfg.family == "encdec" else 0)
    per = 2.0 * B * q_len * cfg.d_model * BF16
    fwd = L * 2 * per
    return fwd * (3.0 if train else 1.0)


def _moe_collectives(cfg: ModelConfig, B: int, q_len: int, train: bool) -> float:
    if cfg.family != "moe":
        return 0.0
    n_moe = cfg.num_layers // max(cfg.moe_every, 1)
    k = cfg.num_experts_per_tok
    per = 2.0 * B * q_len * cfg.d_model * BF16 * max(k, 1)  # dispatch + combine
    return n_moe * 2 * per * (3.0 if train else 1.0)


def step_cost(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
              fsdp: bool = False, num_microbatches: int = 1,
              data_size: int = 16, w_bytes: float = None,
              cache_elem_bytes: float = BF16,
              weight_gather: bool = None) -> StepCost:
    """weight_gather: whether fsdp-sharded weights are all-gathered per step
    (ZeRO-inference). serve_2d keeps weights resident (partial matmuls) ->
    pass False; defaults to the fsdp flag."""
    B, S = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    if w_bytes is None:
        w_bytes = FP32 if shape.kind == "train" else BF16
    p_bytes = cfg.param_count() * w_bytes
    if weight_gather is None:
        weight_gather = fsdp

    if shape.kind == "train":
        # fwd + bwd = 6ND; remat recompute adds ~2ND
        core = 8.0 * n_active * B * S
        attn = _attn_flops(cfg, B, S, S) * 4  # fwd+bwd+remat
        ssm = _ssm_flops(cfg, B, S) * 4
        flops = core + attn + ssm
        act_io = 4.0 * cfg.num_layers * B * S * cfg.d_model * BF16
        opt_bytes = cfg.param_count() * FP32 * (3 if True else 1) * 2  # m,v r/w
        hbm = p_bytes * 2 + opt_bytes + act_io
        coll = (_tp_collectives(cfg, B, S, True)
                + _moe_collectives(cfg, B, S, True)
                + 2.0 * cfg.param_count() * FP32)          # grad reduce
        if fsdp:
            coll += cfg.param_count() * FP32 * num_microbatches  # re-gathers
        return StepCost(flops, hbm, coll)

    if shape.kind == "prefill":
        flops = 2.0 * n_active * B * S + _attn_flops(cfg, B, S, S) + _ssm_flops(cfg, B, S)
        hbm = p_bytes + _cache_bytes(cfg, B, S, S) * (cache_elem_bytes / BF16) \
            + 2.0 * cfg.num_layers * B * S * cfg.d_model * BF16
        coll = _tp_collectives(cfg, B, S, False) + _moe_collectives(cfg, B, S, False)
        if weight_gather and shape.kind != "train":
            coll += p_bytes
        return StepCost(flops, hbm, coll)

    # decode: ONE token against a cache of length S
    flops = (2.0 * n_active * B + _attn_flops(cfg, B, 1, S)
             + _ssm_flops(cfg, B, 1))  # unembed matmul is inside 2*N*D (tied N)
    hbm = p_bytes + _cache_bytes(cfg, B, S, 1) * (cache_elem_bytes / BF16)
    coll = _tp_collectives(cfg, B, 1, False) + _moe_collectives(cfg, B, 1, False)
    if weight_gather:
        coll += p_bytes
    return StepCost(flops, hbm, coll)


def scan_trips(cfg: ModelConfig, kind: str, num_microbatches: int = 1) -> int:
    """The reference's layer-scan trip count for a step (its dry run
    multiplies XLA's once-counted scan body by it): the layers, the moe
    family's blocks, the hybrid family's whole pattern blocks (its tail
    units are unrolled), the encoder-decoder's decoder plus encoder
    layers; a train step repeats them per microbatch. The dry-run record
    carries it as JAX's does."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        trips = cfg.num_layers // len(pat)
    elif cfg.family == "moe":
        trips = cfg.num_layers // max(cfg.moe_every, 1)
    elif cfg.family == "encdec":
        trips = cfg.num_layers + cfg.num_encoder_layers
    else:
        trips = cfg.num_layers
    if kind == "train":
        trips *= max(num_microbatches, 1)
    return max(trips, 1)
