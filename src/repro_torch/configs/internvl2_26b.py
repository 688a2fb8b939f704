"""InternVL2-26B [arXiv:2404.16821] — InternViT (STUB frontend) + InternLM2-20B
language model; vision patches arrive as precomputed embeddings
[B, num_vision_tokens, VIT_DIM] (``models.vlm``), as in the JAX config."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
        num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
        num_vision_tokens=256, rope_theta=1000000.0,
        source="arXiv:2404.16821",
    )


def drafter_config():
    return config().replace(name="internvl2-draft", num_layers=10, d_model=1536,
                            num_heads=12, num_kv_heads=4, head_dim=128, d_ff=4096)


def smoke_config():
    return config().replace(name="internvl2-smoke", num_layers=2, d_model=256,
                            num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                            vocab_size=512, num_vision_tokens=8,
                            dtype="float32", param_dtype="float32")
