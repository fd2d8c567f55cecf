"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-110B card family].

80L, d_model=8192, 64H (GQA kv=8), d_ff=49152, vocab=152064."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    citation="hf:Qwen/Qwen1.5-110B (assignment cites Qwen1.5 family card)",
    d_model=8192, vocab_size=152064,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=49152,
    super_block=(SubLayer(mixer="attention", ffn="mlp"),), num_repeats=80,
    qkv_bias=True, rope_theta=1_000_000.0, norm="rmsnorm", activation="swiglu",
)
