"""Llama 3.2 1B [hf:meta-llama/Llama-3.2-1B] — dense, GQA kv=8.
Doubles as the paper's drafter model (Table I)."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
        num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )


def drafter_config():
    # a same-family ~340M drafter for the 1B target
    return config().replace(name="llama3.2-1b-draft", num_layers=8, d_model=1024,
                            num_heads=16, num_kv_heads=8, head_dim=64, d_ff=4096)


def smoke_config():
    return config().replace(name="llama3.2-1b-smoke", num_layers=2, d_model=256,
                            num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                            vocab_size=512, dtype="float32", param_dtype="float32")
