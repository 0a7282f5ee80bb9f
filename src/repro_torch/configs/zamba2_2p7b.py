"""Zamba2 2.7B  [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

54 layers: Mamba-2 (SSD) layers with one *weight-shared* full transformer
block at every 6th position (45 ``mamba2``, 9 ``shared_attn``), d_model
2560, ssm_state 64 (head_dim 64, expand 2 → d_inner 5120, 80 SSD heads),
shared attention 32 heads (kv 32, head_dim 80), GeGLU FFN 10 240, vocab
32 000, tied embeddings.  The same values as
``repro/configs/zamba2_2p7b.py``.

Simplification, as in the reference: Zamba2 concatenates the residual with
the original embedding at the shared block and uses two alternating shared
blocks with LoRA adapters; here one weight-tied block is run at the same
positions.  So the model has 1 981 756 080 parameters (7.93 GB in
float32), not the public 2.7e9.
"""
from repro_torch.models.config import (AttnConfig, ModelConfig, SSMConfig,
                                       repeat_program)

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    d_model=2560,
    n_layers=54,
    vocab_size=32_000,
    d_ff=10_240,
    layer_program=repeat_program(
        ("mamba2",) * 5 + ("shared_attn",), 54),
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                    rope_theta=10_000.0),
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  head_dim=64, n_groups=1, chunk=128),
    act="geglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    d_model=64,
    n_layers=6,
    vocab_size=512,
    d_ff=128,
    layer_program=repeat_program(("mamba2",) * 5 + ("shared_attn",), 6),
    attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                    rope_theta=10_000.0),
    ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                  head_dim=16, n_groups=1, chunk=32),
    act="geglu",
    tie_embeddings=True,
)

LONG_OK = True      # hybrid: SSD state is O(1); 9 shared-attn KV caches
