"""Llama 3.2 3B [hf:meta-llama/Llama-3.2-3B] — the paper's TARGET model (Table I).
Drafter = Llama 3.2 1B, exactly as in the paper."""
from repro_torch.configs import llama3_2_1b
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
        num_heads=24, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-3B (paper Table I target)",
    )


def drafter_config():
    return llama3_2_1b.config()


def smoke_config():
    return config().replace(name="llama3.2-3b-smoke", num_layers=2, d_model=256,
                            num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                            vocab_size=512, dtype="float32", param_dtype="float32")
