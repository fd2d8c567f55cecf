"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].

32L = 4 super-blocks x 8 sublayers (attention at index 0, mamba at 1..7),
MoE (16e top-2) on every other sublayer; d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=65536.  NOTE (DESIGN.md §2): Jamba's Mamba-1 layers are
implemented with the framework's Mamba-2/SSD mixer (state 64) — the
TPU-friendly chunked-dual form."""
from repro_torch.models.config import ModelConfig, SubLayer

_SB = tuple(
    SubLayer(mixer="attention" if i == 0 else "mamba2",
             ffn="moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    citation="arXiv:2403.19887",
    d_model=4096, vocab_size=65536,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    super_block=_SB, num_repeats=4,
    num_experts=16, top_k=2,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=128,
    rope_theta=None,  # Jamba uses no positional encoding (Mamba provides it)
    norm="rmsnorm", activation="swiglu",
)
