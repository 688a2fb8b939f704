"""Llama 3 405B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="llama3-405b", family="dense", num_layers=126, d_model=16384,
        num_heads=128, num_kv_heads=8, head_dim=128, d_ff=53248, vocab_size=128256,
        rope_theta=500000.0, source="arXiv:2407.21783",
    )


def drafter_config():
    # llama3.1-8B-shaped drafter, per the llama3 family
    return config().replace(name="llama3-405b-draft", num_layers=32, d_model=4096,
                            num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336)


def smoke_config():
    return config().replace(name="llama3-405b-smoke", num_layers=2, d_model=256,
                            num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
                            vocab_size=512, dtype="float32", param_dtype="float32")
