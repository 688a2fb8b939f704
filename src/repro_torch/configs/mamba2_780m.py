"""Mamba2 780M [arXiv:2405.21060] — attention-free SSD, d_state=128."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        ssm_conv=4, ssm_chunk=128, tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def drafter_config():
    return config().replace(name="mamba2-draft", num_layers=12, d_model=768)


def smoke_config():
    return config().replace(name="mamba2-smoke", num_layers=2, d_model=128,
                            ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
                            vocab_size=512, dtype="float32", param_dtype="float32")
