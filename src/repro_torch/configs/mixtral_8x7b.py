"""Mixtral 8x7B [arXiv:2401.04088] — MoE 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
        num_experts=8, num_experts_per_tok=2, sliding_window=4096,
        rope_theta=1e6, source="arXiv:2401.04088",
    )


def drafter_config():
    return config().replace(name="mixtral-draft", num_layers=8, d_model=1024,
                            num_heads=16, num_kv_heads=8, head_dim=64, d_ff=3584,
                            num_experts=8, num_experts_per_tok=2)


def smoke_config():
    return config().replace(name="mixtral-smoke", num_layers=2, d_model=128,
                            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, num_experts=4, num_experts_per_tok=2,
                            sliding_window=16, dtype="float32", param_dtype="float32")
