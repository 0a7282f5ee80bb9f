"""IBM Granite 3.0 1B-A400M base  [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads (GQA kv=8, head_dim 64), 32 experts of
width 512 (top-8, SwiGLU, no shared expert), vocab 49 155, tied
embeddings.  Granite's embedding / residual / attention multiplier scalars
are omitted (constant rescalings), as in the reference.  The same values
as ``repro/configs/granite_moe_1b_a400m.py``.

``capacity_factor`` is left at 0: the capacity path then packs each expert
at 1.25× its mean load (``models.moe.capacity``), as the reference's code
does.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    d_model=1024,
    n_layers=24,
    vocab_size=49_155,
    d_ff=512,
    layer_program=("attn_moe",) * 24,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=64,
                    rope_theta=10_000.0),
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512, num_shared=0),
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    d_model=64,
    n_layers=3,
    vocab_size=512,
    d_ff=32,
    layer_program=("attn_moe",) * 3,
    attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    # capacity_factor = E/K: dropless
    moe=MoEConfig(num_experts=8, top_k=4, d_expert=32, num_shared=0,
                  capacity_factor=2.0),
    act="swiglu",
    tie_embeddings=True,
)
