"""Qwen2-VL 2B  [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B].

28 layers, d_model 1536, 12 heads (GQA kv=2, head_dim 128), FFN 8960
(SwiGLU), vocab 151 936, **M-RoPE** with (t, h, w) sections (16, 24, 24)
over the 64 rotary frequencies, tied embeddings.  The same values as
``repro/configs/qwen2_vl_2b.py``.

The vision tower is a stub, as in the reference: a batch may carry
precomputed patch embeddings ``vision_embed (B, P, D)``, a slot map
``vision_slot (B, S)`` (-1 = text) and the three position rows
``positions3 (3, B, S)`` that M-RoPE reads (``models/lm.py``).
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    d_model=1536,
    n_layers=28,
    vocab_size=151_936,
    d_ff=8960,
    layer_program=("attn",) * 28,
    attn=AttnConfig(n_heads=12, n_kv_heads=2, head_dim=128,
                    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24)),
    act="swiglu",
    pos_embed="mrope",
    vision_stub=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    d_model=64,
    n_layers=3,
    vocab_size=512,
    d_ff=128,
    layer_program=("attn",) * 3,
    attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                    rope_theta=1_000_000.0, mrope_sections=(2, 3, 3)),
    act="swiglu",
    pos_embed="mrope",
    vision_stub=True,
    tie_embeddings=True,
)
