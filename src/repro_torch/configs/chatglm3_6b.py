"""ChatGLM3-6B [arXiv:2406.12793; hf]: GQA kv=2, 2d (partial) RoPE, QKV bias."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024, d_head=128,
        rope="partial2d", rope_pct=0.5, attn_bias=True,
        norm="rmsnorm", act="silu", glu=True)
