"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256; RoPE
theta=500000, SwiGLU, RMSNorm, tied embeddings (as the 1B card ties)."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    citation="hf:meta-llama/Llama-3.2-1B",
    d_model=2048, vocab_size=128256,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192,
    super_block=(SubLayer(mixer="attention", ffn="mlp"),), num_repeats=16,
    rope_theta=500_000.0, norm="rmsnorm", activation="swiglu",
    tie_embeddings=True,
)
