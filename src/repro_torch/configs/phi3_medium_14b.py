"""Phi-3 Medium 14B  [arXiv:2404.14219; hf:microsoft/Phi-3-medium-4k-instruct].

40 layers, d_model 5120, 40 heads (GQA kv=10, head_dim 128), FFN 17920
(SwiGLU), RoPE θ=10k, vocab 100 352, untied head.  The same values as
``repro/configs/phi3_medium_14b.py``.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    d_model=5120,
    n_layers=40,
    vocab_size=100_352,
    d_ff=17_920,
    layer_program=("attn",) * 40,
    attn=AttnConfig(n_heads=40, n_kv_heads=10, head_dim=128,
                    rope_theta=10_000.0),
    act="swiglu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    d_model=64,
    n_layers=3,
    vocab_size=512,
    d_ff=192,
    layer_program=("attn",) * 3,
    attn=AttnConfig(n_heads=8, n_kv_heads=2, head_dim=8),
    act="swiglu",
    tie_embeddings=False,
)
