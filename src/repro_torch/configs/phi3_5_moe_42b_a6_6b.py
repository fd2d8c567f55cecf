"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32H (GQA kv=8), expert d_ff=6400, vocab=32064."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    d_model=4096, vocab_size=32064,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=6400,
    super_block=(SubLayer(mixer="attention", ffn="moe"),), num_repeats=32,
    num_experts=16, top_k=2,
    rope_theta=10_000.0, norm="layernorm", activation="swiglu",
)
