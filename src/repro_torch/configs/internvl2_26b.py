"""InternVL2-26B [arXiv:2404.16821]: InternLM2-20B LM backbone; InternViT
frontend stubbed as 256 precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, d_head=128,
        norm="rmsnorm", act="silu", glu=True, frontend="vision",
        vision_tokens=256)
