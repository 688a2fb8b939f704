"""Granite 3.0 2B [hf:ibm-granite/granite-3.0-2b-base] — dense GQA.

As in the JAX config, none of the checkpoint's embedding, residual,
attention or logit multipliers is carried: the model is the plain
llama-style dense block at Granite's widths."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
        num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=49155,
        rope_theta=10000.0, tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def drafter_config():
    return config().replace(name="granite-draft", num_layers=10, d_model=1024,
                            num_heads=16, num_kv_heads=8, head_dim=64, d_ff=2560)


def smoke_config():
    return config().replace(name="granite-smoke", num_layers=2, d_model=256,
                            num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                            vocab_size=512, dtype="float32", param_dtype="float32")
