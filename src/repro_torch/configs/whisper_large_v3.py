"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder, conv frontend STUBBED
(the caller feeds 1500 frame embeddings [B, encoder_seq, d_model];
``models.encdec``). MHA (kv = heads = 20)."""
from repro_torch.configs.base import ModelConfig


def config():
    return ModelConfig(
        name="whisper-large-v3", family="encdec", num_layers=32, d_model=1280,
        num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
        num_encoder_layers=32, encoder_seq=1500, tie_embeddings=True,
        source="arXiv:2212.04356",
    )


def drafter_config():
    # whisper-small-shaped drafter with its own encoder over its own frames
    return config().replace(name="whisper-draft", num_layers=12, d_model=768,
                            num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
                            num_encoder_layers=12)


def smoke_config():
    return config().replace(name="whisper-smoke", num_layers=2, d_model=128,
                            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
                            vocab_size=512, num_encoder_layers=2, encoder_seq=16,
                            dtype="float32", param_dtype="float32")
