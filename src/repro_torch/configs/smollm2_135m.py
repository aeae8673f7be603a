"""SmolLM2-135M [hf:HuggingFaceTB/SmolLM2-135M] — the paper's own
end-to-end model."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm2-135m", family="dense", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152, d_head=64,
        norm="rmsnorm", act="silu", glu=True, tie_embeddings=True)
