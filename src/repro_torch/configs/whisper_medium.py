"""Whisper medium  [arXiv:2212.04356; hf:openai/whisper-medium].

Encoder–decoder, 24 + 24 layers, d_model 1024, 16 heads (kv 16, head_dim
64), FFN 4096 (GELU, not gated), LayerNorm, learned positions, vocab
51 865, tied embeddings.  The same values as
``repro/configs/whisper_medium.py``: 793 073 664 parameters (3.17 GB in
float32).

The modality frontend is a stub, as in the reference: the model takes
precomputed mel→conv embeddings ``audio_embed (B, 1500, 1024)``.  The
decoder's learned position table has 32 768 rows (the reference's decode
cells go past whisper's trained context of 448).
"""
from repro_torch.models.config import AttnConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    d_model=1024,
    n_layers=24,
    vocab_size=51_865,
    d_ff=4096,
    layer_program=("xattn",) * 24,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64),
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    act="gelu",
    norm="layernorm",
    pos_embed="learned",
    max_position=32_768,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    d_model=64,
    n_layers=3,
    vocab_size=512,
    d_ff=128,
    layer_program=("xattn",) * 3,
    attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
    encoder=EncoderConfig(n_layers=2, n_frames=16),
    act="gelu",
    norm="layernorm",
    pos_embed="learned",
    max_position=128,
    tie_embeddings=True,
)
