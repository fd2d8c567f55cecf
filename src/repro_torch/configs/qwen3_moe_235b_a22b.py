"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family; dims as assigned: 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128e top-8]."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B (assigned dims: 235B-A22B)",
    d_model=4096, vocab_size=151936,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    super_block=(SubLayer(mixer="attention", ffn="moe"),), num_repeats=94,
    num_experts=128, top_k=8,
    rope_theta=1_000_000.0, norm="rmsnorm", activation="swiglu",
)
