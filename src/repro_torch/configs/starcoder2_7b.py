"""starcoder2-7b [dense] — GQA, RoPE, native sliding window 4096
[arXiv:2402.19173].

32L, d_model=4608, 36H (GQA kv=4), d_ff=18432, vocab=49152; LayerNorm +
GeLU MLP, QKV bias, sliding_window=4096 (this is what makes long_500k
native for a dense arch: rolling KV cache of 4096 slots)."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    citation="arXiv:2402.19173",
    d_model=4608, vocab_size=49152,
    num_heads=36, num_kv_heads=4, head_dim=128, d_ff=18432,
    super_block=(SubLayer(mixer="attention", ffn="mlp"),), num_repeats=32,
    qkv_bias=True, sliding_window=4096,
    rope_theta=100_000.0, norm="layernorm", activation="gelu",
)
