"""Gemma 2 2B  [arXiv:2408.00118; hf:google/gemma-2-2b].

26 layers alternating local (window 4096) / global attention, d_model 2304,
8 heads (GQA kv=4, head_dim 256), FFN 9216 (GeGLU), attention-logit softcap
50, final-logit softcap 30, vocab 256 000, embeddings scaled √d.  The same
values as ``repro/configs/gemma2_2b.py``.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, repeat_program

CONFIG = ModelConfig(
    name="gemma2-2b",
    d_model=2304,
    n_layers=26,
    vocab_size=256_000,
    d_ff=9216,
    layer_program=repeat_program(("local", "attn"), 26),
    attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                    rope_theta=10_000.0, window=4096, softcap=50.0),
    act="geglu",
    embed_scale=True,
    logit_softcap=30.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    d_model=64,
    n_layers=4,
    vocab_size=512,
    d_ff=128,
    layer_program=repeat_program(("local", "attn"), 4),
    attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                    rope_theta=10_000.0, window=8, softcap=50.0),
    act="geglu",
    embed_scale=True,
    logit_softcap=30.0,
    tie_embeddings=True,
)
