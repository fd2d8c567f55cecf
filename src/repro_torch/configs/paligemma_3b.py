"""paligemma-3b [vlm] — SigLIP vision stub + gemma decoder [arXiv:2407.07726].

18L, d_model=2048, 8H (MQA kv=1, head_dim=256), d_ff=16384, vocab=257216.
The SigLIP ViT + projector are a stub: input_specs() provides (B, 256, 2048)
patch embeddings; the prefix-LM mask (bidirectional prefix, causal suffix)
is implemented in chunked_attention."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    citation="arXiv:2407.07726",
    d_model=2048, vocab_size=257216,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    super_block=(SubLayer(mixer="attention", ffn="mlp"),), num_repeats=18,
    prefix_tokens=256,
    rope_theta=10_000.0, norm="rmsnorm", activation="swiglu",
    tie_embeddings=True,
)
