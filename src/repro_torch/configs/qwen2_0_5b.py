"""qwen2-0.5b [dense] — GQA with QKV bias [arXiv:2407.10671].

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    citation="arXiv:2407.10671",
    d_model=896, vocab_size=151936,
    num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864,
    super_block=(SubLayer(mixer="attention", ffn="mlp"),), num_repeats=24,
    qkv_bias=True, rope_theta=1_000_000.0, norm="rmsnorm", activation="swiglu",
    tie_embeddings=True,
)
