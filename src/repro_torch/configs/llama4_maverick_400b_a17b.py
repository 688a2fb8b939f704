"""Llama 4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] —
MoE 128 experts top-1 with a shared expert, early-fusion multimodal (text path here)."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
        num_experts=128, num_experts_per_tok=1, num_shared_experts=1,
        moe_every=2,  # llama4 interleaves dense/MoE layers -> ~400B total
        rope_theta=500000.0, source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def drafter_config():
    return config().replace(name="llama4-draft", num_layers=8, d_model=1280,
                            num_heads=10, num_kv_heads=2, head_dim=128, d_ff=2048,
                            num_experts=16, num_experts_per_tok=1, num_shared_experts=1)


def smoke_config():
    return config().replace(name="llama4-smoke", num_layers=2, d_model=128,
                            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, num_experts=4, num_experts_per_tok=1,
                            num_shared_experts=1, dtype="float32", param_dtype="float32")
