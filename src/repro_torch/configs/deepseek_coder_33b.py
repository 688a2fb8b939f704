"""DeepSeek-Coder 33B [arXiv:2401.14196] — llama-arch dense (assigned GQA kv=8)."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="deepseek-coder-33b", family="dense", num_layers=62, d_model=7168,
        num_heads=56, num_kv_heads=8, head_dim=128, d_ff=19200, vocab_size=32256,
        rope_theta=100000.0, source="arXiv:2401.14196",
    )


def drafter_config():
    return config().replace(name="deepseek-coder-draft", num_layers=12, d_model=2048,
                            num_heads=16, num_kv_heads=8, head_dim=128, d_ff=5504)


def smoke_config():
    return config().replace(name="deepseek-smoke", num_layers=2, d_model=256,
                            num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
                            vocab_size=512, dtype="float32", param_dtype="float32")
