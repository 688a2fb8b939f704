"""RecurrentGemma 2B [arXiv:2402.19427] — RG-LRU + local attention, 1:2
pattern, MQA (kv=1). 26 layers = 8 x (rec, rec, attn) + 2 tail rec layers.

As in the JAX config, the model is the plain ``models.hybrid`` block at
RecurrentGemma's widths, not the published checkpoint's exact layers
(ROADMAP.md lists where they part)."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
        num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=("rec", "rec", "attn"), lru_width=2560, local_window=2048,
        tie_embeddings=True, source="arXiv:2402.19427",
    )


def drafter_config():
    return config().replace(name="recurrentgemma-draft", num_layers=8, d_model=1024,
                            num_heads=4, num_kv_heads=1, head_dim=256, d_ff=3072,
                            lru_width=1024)


def smoke_config():
    return config().replace(name="recurrentgemma-smoke", num_layers=5, d_model=128,
                            num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
                            vocab_size=512, lru_width=128, local_window=16,
                            dtype="float32", param_dtype="float32")
