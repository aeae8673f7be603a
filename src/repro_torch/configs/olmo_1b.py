"""OLMo-1B [arXiv:2402.00838; hf]: dense MHA, non-parametric LayerNorm."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304, d_head=128,
        norm="layernorm_np", act="silu", glu=True, tie_embeddings=True)
