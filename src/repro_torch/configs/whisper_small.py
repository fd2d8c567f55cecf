"""whisper-small [audio] — encoder-decoder, conv frontend STUB
[arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768, 12H, d_ff=3072, vocab=51865.
The mel-spectrogram + conv feature extractor is a stub: input_specs()
provides precomputed (B, 1500, 768) frame embeddings.  Sinusoidal positions
stand in for Whisper's learned decoder embeddings (noted in DESIGN.md)."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    citation="arXiv:2212.04356",
    d_model=768, vocab_size=51865,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
    super_block=(SubLayer(mixer="attention", ffn="mlp", cross_attention=True),),
    num_repeats=12,
    encoder_layers=12, encoder_seq=1500,
    qkv_bias=True, rope_theta=None, norm="layernorm", activation="gelu",
    tie_embeddings=True,
)
