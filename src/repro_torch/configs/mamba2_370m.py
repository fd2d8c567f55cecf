"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1024, attention-free, ssm_state=128, vocab=50280 (GPT-NeoX)."""
from repro_torch.models.config import ModelConfig, SubLayer

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    citation="arXiv:2405.21060",
    d_model=1024, vocab_size=50280,
    super_block=(SubLayer(mixer="mamba2", ffn="none"),), num_repeats=48,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=128,
    rope_theta=None, norm="rmsnorm",
    tie_embeddings=True,
)
