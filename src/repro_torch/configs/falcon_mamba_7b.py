"""Falcon-Mamba 7B  [arXiv:2410.05355; hf:tiiuae/falcon-mamba-7b].

64 pure Mamba-1 layers (attention-free), d_model 4096, d_state 16,
d_conv 4, expand 2 (d_inner 8192, dt_rank 256), vocab 65 024, untied head.
The same values as ``repro/configs/falcon_mamba_7b.py``.  Attention's
kernels are unused; the selective scan runs as the gathered executor's
``mamba`` site function (``csrc/lm_sites.cuh``), site = channel.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    d_model=4096,
    n_layers=64,
    vocab_size=65_024,
    d_ff=0,
    layer_program=("mamba1",) * 64,
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2),
    pos_embed="none",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    d_model=64,
    n_layers=4,
    vocab_size=512,
    d_ff=0,
    layer_program=("mamba1",) * 4,
    ssm=SSMConfig(kind="mamba1", d_state=8, d_conv=4, expand=2),
    pos_embed="none",
    tie_embeddings=False,
)
