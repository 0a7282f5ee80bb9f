"""Nemotron-4 15B  [arXiv:2402.16819].

32 layers, d_model 6144, 48 heads (GQA kv=8, head_dim 128), FFN 24576 with
squared-ReLU (non-gated), RoPE, vocab 256 000, untied output layer,
LayerNorm (no bias, the ``(1 + w)`` scale).  The same values as
``repro/configs/nemotron_4_15b.py``.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    d_model=6144,
    n_layers=32,
    vocab_size=256_000,
    d_ff=24_576,
    layer_program=("attn",) * 32,
    attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                    rope_theta=10_000.0),
    act="relu2",
    norm="layernorm",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    d_model=64,
    n_layers=3,
    vocab_size=512,
    d_ff=256,
    layer_program=("attn",) * 3,
    attn=AttnConfig(n_heads=8, n_kv_heads=2, head_dim=8),
    act="relu2",
    norm="layernorm",
    tie_embeddings=False,
)
