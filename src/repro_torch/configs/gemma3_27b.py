"""Gemma 3 27B  [google/gemma-3 technical report; hf:google/gemma-3-27b-pt].

62 layers in a 5:1 local:global pattern (window 1024; local rope θ=10k,
global θ=1M), d_model 5376, 32 heads (GQA kv=16, head_dim 128), FFN 21504
(GeGLU), vocab 262 144, RMSNorm with qk-norm, embeddings scaled √d.  The
same values as ``repro/configs/gemma3_27b.py``.  The 62 layers' float32
weights (108 GB) exceed one card; ``configs.first_layers`` cuts the depth
to whole 5:1 groups.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, repeat_program

CONFIG = ModelConfig(
    name="gemma3-27b",
    d_model=5376,
    n_layers=62,
    vocab_size=262_144,
    d_ff=21_504,
    layer_program=repeat_program(
        ("local", "local", "local", "local", "local", "attn"), 62),
    attn=AttnConfig(n_heads=32, n_kv_heads=16, head_dim=128,
                    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
                    window=1024, qk_norm=True),
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    d_model=64,
    n_layers=6,
    vocab_size=512,
    d_ff=128,
    layer_program=repeat_program(
        ("local", "local", "local", "local", "local", "attn"), 6),
    attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
                    window=8, qk_norm=True),
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
