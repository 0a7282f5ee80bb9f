"""DeepSeek-V3 671B  [arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3].

61 layers (first 3 dense, 58 MoE), d_model 7168, 128 heads, MLA
(q_lora 1536, kv_lora 512, rope 64, nope 128, v 128), dense FFN 18432,
MoE: 1 shared + 256 routed experts of width 2048, top-8, vocab 129 280,
multi-token prediction depth 1.  The same values as
``repro/configs/deepseek_v3_671b.py``.

Documented simplifications, as in the reference (systems-neutral):
  * softmax top-8 routing stands in for sigmoid + group-limited top-k;
  * the aux-loss-free bias update is not modelled.

The whole model is 6.83e11 parameters (2.73 TB in float32).  One card
holds full-width cuts (``configs.first_layers``): the first 4 layers (3
``attn_dense`` + 1 ``attn_moe``, every block type) without the MTP block
are 15 111 093 248 parameters (60.44 GB), served; the first 3 with the MTP
block (``attn_dense`` at that cut, the program's last) are 4 290 058 240
(17.16 GB), trained.
"""
from repro_torch.models.config import (AttnConfig, MLAConfig, ModelConfig,
                                       MoEConfig)

N_DENSE = 3
N_LAYERS = 61

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    n_layers=N_LAYERS,
    vocab_size=129_280,
    d_ff=18_432,                       # the 3 leading dense layers
    layer_program=("attn_dense",) * N_DENSE +
                  ("attn_moe",) * (N_LAYERS - N_DENSE),
    attn=AttnConfig(n_heads=128, n_kv_heads=128, head_dim=128,
                    rope_theta=10_000.0),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    act="swiglu",
    tie_embeddings=False,
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    d_model=64,
    n_layers=4,
    vocab_size=512,
    d_ff=160,
    layer_program=("attn_dense",) + ("attn_moe",) * 3,
    attn=AttnConfig(n_heads=8, n_kv_heads=8, head_dim=8),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
    # capacity_factor = E/K ⇒ cap ≥ T ⇒ provably dropless (an expert can
    # receive at most T assignments)
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                  capacity_factor=4.0),
    act="swiglu",
    tie_embeddings=False,
    mtp_depth=1,
)

LONG_OK = False    # full attention at every layer
