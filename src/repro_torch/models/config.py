"""Model configuration — one dataclass family covering the registry's archs.

A copy of the framework-free ``repro/models/config.py`` (the port imports
nothing of ``repro``).  A model is described by a *layer program*: a tuple
of block-type names of length ``n_layers`` (e.g. ``local, attn`` repeating
for gemma2).  The reference compiles the program into scan groups with
:func:`plan_layer_groups` to keep its HLO small; the port runs its layers in
a plain Python loop and uses the groups only to read the reference's
stacked parameters (:func:`repro_torch.models.params.from_reference`).

Block types:
  ``attn``         global causal attention + MLP
  ``local``        sliding-window causal attention + MLP
  ``attn_dense``   attention + dense MLP (MoE models' leading dense layers)
  ``attn_moe``     attention + MoE MLP
  ``mamba1``       Mamba-1 selective-scan mixer (no MLP; falcon style)
  ``mamba2``       Mamba-2 SSD mixer (zamba style)
  ``shared_attn``  full transformer block with weight-tied (shared) params
  ``xattn``        decoder block with self- + cross-attention (whisper)
  ``enc``          bidirectional encoder block (whisper encoder)

An encoder–decoder model (whisper) has an :class:`EncoderConfig`: its
``enc`` stack runs over the stub frontend's frames, and every ``xattn``
decoder block attends to its output.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

BLOCK_TYPES = ("attn", "local", "attn_dense", "attn_moe", "mamba1", "mamba2",
               "shared_attn", "xattn", "enc")


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0   # sliding-window layers' theta (gemma3)
    window: int = 0                 # sliding-window size; 0 = global
    softcap: float = 0.0            # attention logit soft-capping (gemma2)
    qk_norm: bool = False           # RMSNorm on q/k heads (gemma3)
    scale: Optional[float] = None   # softmax scale; None → head_dim**-0.5
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN width
    num_shared: int = 0             # shared experts (deepseek: 1)
    router_scale: bool = True       # normalise top-k weights to sum 1
    capacity_factor: float = 0.0    # 0 → dropless (sort + ragged_dot)


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba1"            # "mamba1" | "mamba2"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 → ceil(d_model/16)
    head_dim: int = 64              # mamba2 only
    n_groups: int = 1               # mamba2 B/C groups
    chunk: int = 128                # SSD / scan chunk length


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int                   # stub frontend: precomputed frames
    d_model: int = 0                # 0 → same as decoder


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab_size: int
    d_ff: int
    layer_program: tuple[str, ...]
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None

    act: str = "swiglu"             # "swiglu" | "relu2" | "gelu" (+gated)
    norm: str = "rmsnorm"           # "rmsnorm" | "layernorm"
    pos_embed: str = "rope"         # "rope" | "mrope" | "learned" | "none"
    max_position: int = 1 << 20     # learned pos-embed table length cap
    tie_embeddings: bool = True
    embed_scale: bool = False       # × sqrt(d_model) at embedding (gemma)
    logit_softcap: float = 0.0      # final-logit capping (gemma2)
    mtp_depth: int = 0              # deepseek multi-token-prediction blocks
    vision_stub: bool = False       # qwen2-vl: merge precomputed patch embeds
    vocab_pad_to: int = 256         # pad vocab to a multiple (sharding)

    def __post_init__(self):
        if len(self.layer_program) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_program has {len(self.layer_program)} "
                f"entries for n_layers={self.n_layers}")
        unknown = set(self.layer_program) - set(BLOCK_TYPES)
        if unknown:
            raise ValueError(f"{self.name}: unknown block types {unknown}")
        needs_attn = {"attn", "local", "attn_dense", "attn_moe",
                      "shared_attn", "xattn", "enc"}
        if needs_attn & set(self.layer_program) and \
                self.attn is None and self.mla is None:
            raise ValueError(f"{self.name}: attention blocks need attn/mla config")
        if "attn_moe" in self.layer_program and self.moe is None:
            raise ValueError(f"{self.name}: attn_moe blocks need moe config")
        if {"mamba1", "mamba2"} & set(self.layer_program) and self.ssm is None:
            raise ValueError(f"{self.name}: ssm blocks need ssm config")

    # -- derived -------------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def is_attention_free(self) -> bool:
        return not ({"attn", "local", "attn_dense", "attn_moe", "shared_attn",
                     "xattn", "enc"} & set(self.layer_program))

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally over the full sequence with
        quadratic prefill cost (SSM / hybrid / mostly-sliding-window)."""
        quad = {"attn", "attn_dense", "attn_moe", "xattn", "enc"}
        n_quad = sum(1 for b in self.layer_program if b in quad)
        return n_quad == 0 or (n_quad / self.n_layers) <= 0.25

    def scaled_down(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def num_params(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline terms)."""
        from . import params as _p  # lazy; avoids import cycle
        return _p.count_params(self)

    def active_params(self) -> int:
        from . import params as _p
        return _p.count_params(self, active_only=True)


def ssm_dims(cfg: ModelConfig) -> tuple[SSMConfig, int, int]:
    """``(ssm config, d_inner, dt_rank)``: the shapes a Mamba layer's
    parameters, cache and mixer share."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return s, d_inner, dt_rank


def repeat_program(pattern: tuple[str, ...], n_layers: int) -> tuple[str, ...]:
    """Cycle ``pattern`` to length ``n_layers``."""
    reps = -(-n_layers // len(pattern))
    return tuple((list(pattern) * reps)[:n_layers])


def plan_layer_groups(program: tuple[str, ...]) -> list[tuple[tuple[str, ...], int]]:
    """Compile a layer program into scan groups ``[(unit, n_repeats), ...]``.

    Prefers the smallest periodic unit (with remainder groups); falls back to
    maximal same-type runs.  Guarantees ``sum(len(u)*k) == len(program)``.
    """
    n = len(program)
    # periodic-with-remainder: smallest p whose repetition covers >= half
    best = None
    for p in range(1, min(n // 2, 16) + 1):
        unit = program[:p]
        k = 1
        while (k + 1) * p <= n and program[k * p:(k + 1) * p] == unit:
            k += 1
        if k >= 2 and k * p >= n - p:          # at most one unit of remainder
            groups = [(unit, k)]
            rem = program[k * p:]
            if rem:
                groups.append((rem, 1))
            best = groups
            break
    if best is not None:
        return best
    # fallback: maximal runs of identical block type
    groups: list[tuple[tuple[str, ...], int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and program[j] == program[i]:
            j += 1
        groups.append(((program[i],), j - i))
        i = j
    return groups
