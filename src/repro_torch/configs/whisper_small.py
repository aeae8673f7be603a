"""Whisper-small [arXiv:2212.04356]: encoder-decoder, the audio frontend
stubbed.  The encoder reads frame embeddings ``[B, seq_len / 4, d]``; the
decoder reads ``seq_len`` tokens."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, d_head=64,
        encoder_layers=12, rope="none", norm="layernorm", act="gelu", glu=False,
        attn_bias=True, tie_embeddings=True, frontend="audio", audio_downsample=4)
