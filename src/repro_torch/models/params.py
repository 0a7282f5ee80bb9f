"""Parameter initialisation, and the carry-across from the JAX package.

The port's parameters are plain dictionaries::

    {"embed": (padded_vocab, d), "final_norm": (d,),
     "layers": [{"norm1": (d,), "attn": {"wq", "wk", "wv", "wo",
                                         "q_norm"?, "k_norm"?},
                 "norm2": (d,), "mlp": {"w_up", "w_gate"?, "w_down"}}, ...]}

one entry of ``"layers"`` per layer of ``cfg.layer_program``, with the leaf
names and shapes of ``repro/models/params.py``.  An ``attn_moe`` layer's
``"mlp"`` is the MoE's ``{"router": (d, E), "w_up": (E, d, fe), "w_gate"?:
(E, d, fe), "w_down": (E, fe, d), "shared"?: {"w_up", "w_gate"?,
"w_down"}}`` (the shared experts a dense MLP of width ``fe·num_shared``);
an ``attn_dense`` layer is an ``attn`` layer.  A ``mamba1`` layer is
``{"norm1": (d,), "mixer": {"w_xm", "w_z", "conv_w", "conv_b", "w_x",
"w_dt", "dt_bias", "a_log", "d_skip", "w_out"}}``; a ``mamba2`` layer is
``{"norm1": (d,), "mixer": {"w_xm", "w_z", "w_B", "w_C", "w_dtin",
"conv_w", "conv_b", "conv_w_bc", "conv_b_bc", "dt_bias", "a_log",
"d_skip", "out_norm", "w_out"}}``.  Under MLA (deepseek-v3) a layer's
``"attn"`` is ``{"w_dq": (d, q_lora), "q_norm": (q_lora,), "w_uq": (q_lora,
H·(nope + rope)), "w_dkv": (d, R), "kv_norm": (R,), "w_kr": (d, rope),
"w_uk": (R, H·nope), "w_uv": (R, H·v), "wo": (H·v, d)}``, and
``params["mtp"]`` holds the ``mtp_depth`` multi-token-prediction modules,
each ``{"proj": (2d, d), "block": <a layer of the program's last type>,
"norm": (d,)}`` (unstacked in the reference too).  A ``shared_attn``
layer is ``{}``: its weights are the one ``params["shared_block"]`` (an
``attn`` block), tied
across every ``shared_attn`` position, so the tree, the optimiser's
moments and a checkpoint hold them once.  An ``xattn`` layer (whisper's
decoder) is an ``attn`` layer with a second attention, ``"xattn"``
(``wq``/``wk``/``wv``/``wo``, its keys and values projected from the
encoder's output), and its norm ``"norm_x"`` (d,); an ``enc`` layer is an
``attn`` layer.  Learned positions add ``params["pos_embed"]:
(max_position, d)``, and an encoder–decoder model ``params["encoder"] =
{"layers": [<enc layer>, ...], "final_norm": (d,), "pos_embed":
(n_frames, d)}``.  The reference stacks
each leaf per scan group (``groups[i][position]`` with a leading repeat
axis: an expert leaf is ``(k, E, d, fe)``); :func:`from_reference`
unstacks that into the per-layer list.  ``attn``/``local``/``attn_dense``/
``attn_moe`` blocks with standard attention (qk-norm's ``q_norm``/
``k_norm``, ``(head_dim,)``, where the config has it) or MLA, ``mamba1``,
``mamba2``, ``shared_attn``, ``xattn`` and ``enc`` blocks, with tied or
untied embeddings, learned positions, an encoder and multi-token
prediction: every block type of the registry.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

from .config import ModelConfig, plan_layer_groups, ssm_dims

def _dense(gen, shape, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=device) * scale


def _mlp_params(cfg: ModelConfig, gen, device, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    mlp = {"w_up": _dense(gen, (d, f), device)}
    if cfg.act in ("swiglu", "geglu"):
        mlp["w_gate"] = _dense(gen, (d, f), device)
    mlp["w_down"] = _dense(gen, (f, d), device)
    return mlp


def _moe_params(cfg: ModelConfig, gen, device) -> dict:
    """The router (d, E); each expert's up/gate (E, d, fe) and down (E, fe,
    d), ~ N(0, 1/fan_in) over the expert's own fan-in; the shared experts
    a dense MLP of width ``fe·num_shared``."""
    mo, d = cfg.moe, cfg.d_model
    e, fe = mo.num_experts, mo.d_expert
    p = {"router": _dense(gen, (d, e), device),
         "w_up": _dense(gen, (e, d, fe), device, fan_in=d)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _dense(gen, (e, d, fe), device, fan_in=d)
    p["w_down"] = _dense(gen, (e, fe, d), device, fan_in=fe)
    if mo.num_shared:
        p["shared"] = _mlp_params(cfg, gen, device, d_ff=fe * mo.num_shared)
    return p


def _mla_params(cfg: ModelConfig, gen, device) -> dict:
    """MLA's projections in the reference's order: the query's down (d,
    q_lora) and up (q_lora, H·(nope + rope)) projections with the norm
    between, the latent's down projection (d, R) and norm, the shared rope
    key (d, rope), the latent's key and value up-projections (R, H·nope),
    (R, H·v) and the output (H·v, d); the up-projections over their rank's
    fan-in."""
    m, h, d = cfg.mla, cfg.attn.n_heads, cfg.d_model
    qk = m.nope_head_dim + m.rope_head_dim
    p = {"w_dq": _dense(gen, (d, m.q_lora_rank), device),
         "q_norm": torch.zeros(m.q_lora_rank, device=device)}
    p["w_uq"] = _dense(gen, (m.q_lora_rank, h * qk), device)
    p["w_dkv"] = _dense(gen, (d, m.kv_lora_rank), device)
    p["kv_norm"] = torch.zeros(m.kv_lora_rank, device=device)
    p["w_kr"] = _dense(gen, (d, m.rope_head_dim), device)
    p["w_uk"] = _dense(gen, (m.kv_lora_rank, h * m.nope_head_dim), device)
    p["w_uv"] = _dense(gen, (m.kv_lora_rank, h * m.v_head_dim), device)
    p["wo"] = _dense(gen, (h * m.v_head_dim, d), device)
    return p


def _attn_params(cfg: ModelConfig, gen, device) -> dict:
    if cfg.mla is not None:
        return _mla_params(cfg, gen, device)
    a, d = cfg.attn, cfg.d_model
    attn = {"wq": _dense(gen, (d, a.n_heads * a.head_dim), device),
            "wk": _dense(gen, (d, a.n_kv_heads * a.head_dim), device),
            "wv": _dense(gen, (d, a.n_kv_heads * a.head_dim), device),
            "wo": _dense(gen, (a.n_heads * a.head_dim, d), device)}
    if a.qk_norm:
        attn["q_norm"] = torch.zeros(a.head_dim, device=device)
        attn["k_norm"] = torch.zeros(a.head_dim, device=device)
    return attn


def _block_params(cfg: ModelConfig, gen, device, btype: str) -> dict:
    """An attention block in the reference's order: ``norm1``, ``attn``,
    ``norm2``, for ``xattn`` the cross-attention and ``norm_x``, then the
    MLP (the MoE's for ``attn_moe``)."""
    d = cfg.d_model
    p = {"norm1": torch.zeros(d, device=device),
         "attn": _attn_params(cfg, gen, device),
         "norm2": torch.zeros(d, device=device)}
    if btype == "xattn":
        p["xattn"] = _attn_params(cfg, gen, device)
        p["norm_x"] = torch.zeros(d, device=device)
    p["mlp"] = (_moe_params(cfg, gen, device) if btype == "attn_moe"
                else _mlp_params(cfg, gen, device))
    return p


def _mamba1_params(cfg: ModelConfig, gen, device) -> dict:
    """The Mamba-1 mixer: split (not fused) projections, ``dt_bias`` the
    softplus-inverse of a log-uniform ``dt`` in [1e-3, 1e-1], ``a_log =
    log(1..N)`` per channel, ``d_skip = 1``."""
    s, di, dtr = ssm_dims(cfg)
    d, n = cfg.d_model, s.d_state
    u = torch.rand(di, generator=gen, device=device)
    dt_init = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {"w_xm": _dense(gen, (d, di), device),
            "w_z": _dense(gen, (d, di), device),
            "conv_w": _dense(gen, (s.d_conv, di), device, fan_in=s.d_conv),
            "conv_b": torch.zeros(di, device=device),
            "w_x": _dense(gen, (di, dtr + 2 * n), device),
            "w_dt": _dense(gen, (dtr, di), device),
            "dt_bias": torch.log(torch.expm1(dt_init)),
            "a_log": torch.log(a).repeat(di, 1),
            "d_skip": torch.ones(di, device=device),
            "w_out": _dense(gen, (di, d), device)}


def _mamba2_params(cfg: ModelConfig, gen, device) -> dict:
    """The Mamba-2 mixer: split projections (x, gate, B, C, dt input),
    the depthwise convs (fan-in ``d_conv``), ``dt_bias`` 0, ``a_log =
    log(linspace(1, 16, H))`` per head, ``d_skip`` 1 and the gated norm's
    ``out_norm`` 0."""
    s, di, _ = ssm_dims(cfg)
    d, gn = cfg.d_model, s.n_groups * s.d_state
    heads = di // s.head_dim
    return {"w_xm": _dense(gen, (d, di), device),
            "w_z": _dense(gen, (d, di), device),
            "w_B": _dense(gen, (d, gn), device),
            "w_C": _dense(gen, (d, gn), device),
            "w_dtin": _dense(gen, (d, heads), device),
            "conv_w": _dense(gen, (s.d_conv, di), device, fan_in=s.d_conv),
            "conv_b": torch.zeros(di, device=device),
            "conv_w_bc": _dense(gen, (s.d_conv, 2 * gn), device,
                                fan_in=s.d_conv),
            "conv_b_bc": torch.zeros(2 * gn, device=device),
            "dt_bias": torch.zeros(heads, device=device),
            "a_log": torch.log(torch.linspace(1.0, 16.0, heads,
                                              device=device)),
            "d_skip": torch.ones(heads, device=device),
            "out_norm": torch.zeros(di, device=device),
            "w_out": _dense(gen, (di, d), device)}


def _layer_params(cfg: ModelConfig, gen, device, btype: str) -> dict:
    if btype == "shared_attn":
        return {}
    if btype in ("mamba1", "mamba2"):
        mixer = _mamba1_params if btype == "mamba1" else _mamba2_params
        return {"norm1": torch.zeros(cfg.d_model, device=device),
                "mixer": mixer(cfg, gen, device)}
    return _block_params(cfg, gen, device, btype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> dict:
    """Random parameters of ``dtype`` from ``generator`` (whose device must
    be ``device``), each leaf drawn in float32 and cast to ``dtype`` as the
    reference's ``init_params(cfg, key, dtype)`` casts it (a layer at a
    time, so no float32 copy of the whole model is ever live):
    projections ~ N(0, 1/fan_in), the embedding and the
    learned position tables ~ N(0, 0.02²), norm weights 0 (the ``(1 + w)``
    convention), the Mamba mixers as :func:`_mamba1_params` and
    :func:`_mamba2_params`, and one ``"shared_block"`` (an ``attn`` block)
    where the program has ``shared_attn`` positions, built at the first of
    them.  The same distributions as the reference's ``init_params``, the
    MoE's as :func:`_moe_params`; not the same numbers (a
    ``torch.Generator`` is not a JAX key).  An encoder–decoder model gets
    ``params["encoder"]`` after the decoder's layers and final norm.  With
    ``cfg.mtp_depth``, ``params["mtp"]`` gets that many modules after
    them, each its block (the program's last type, as the reference
    builds it) and then its ``proj`` ~ N(0, 1/2d)."""
    def cast(tree):          # keeps the dicts' order, as built
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype)

    d = cfg.d_model
    params = {"embed": cast(_dense(generator, (cfg.padded_vocab, d), device,
                                   fan_in=1) * 0.02)}
    if not cfg.tie_embeddings:
        params["lm_head"] = cast(_dense(generator, (d, cfg.padded_vocab),
                                        device))
    if cfg.pos_embed == "learned":
        params["pos_embed"] = cast(_dense(generator, (cfg.max_position, d),
                                          device, fan_in=1) * 0.02)
    layers = []
    for btype in cfg.layer_program:
        if btype == "shared_attn" and "shared_block" not in params:
            params["shared_block"] = cast(_block_params(cfg, generator,
                                                        device, "attn"))
        layers.append(cast(_layer_params(cfg, generator, device, btype)))
    params["layers"] = layers
    params["final_norm"] = torch.zeros(d, dtype=dtype, device=device)
    if cfg.is_encdec:
        enc = cfg.encoder
        params["encoder"] = {
            "layers": [cast(_block_params(cfg, generator, device, "enc"))
                       for _ in range(enc.n_layers)],
            "final_norm": torch.zeros(d, dtype=dtype, device=device),
            "pos_embed": cast(_dense(generator, (enc.n_frames, d), device,
                                     fan_in=1) * 0.02)}
    if cfg.mtp_depth:
        params["mtp"] = []
        for _ in range(cfg.mtp_depth):
            block = _layer_params(cfg, generator, device,
                                  cfg.layer_program[-1])
            params["mtp"].append(cast({
                "proj": _dense(generator, (2 * d, d), device),
                "block": block, "norm": torch.zeros(d, device=device)}))
    return params


def _to_torch(tree, device, index=None, leaf=None, dtype=None):
    """``tree``'s arrays as tensors on ``device`` (slice ``index`` of each
    first), each of ``dtype`` or, with ``None``, of its own: float32, or
    bfloat16 for a leaf whose ``dtype.name`` is ``"bfloat16"`` (carried
    through float32, which holds every bfloat16 value exactly; numpy
    casts it because the caller's process registered the type).  ``leaf``
    converts an array itself instead."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index, leaf, dtype)
                for k, v in tree.items()}
    if leaf is not None:
        return leaf(tree, index)
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    want = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                     else torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, want)


def _unstack(np_params: dict, cfg: ModelConfig, convert) -> dict:
    """The port's per-layer structure from the reference's stacked scan
    groups; ``convert(tree, index)`` turns a subtree (sliced at repeat
    ``index``, or whole for ``None``) into the port's leaves.  The tied
    ``shared_block`` (unstacked in the reference too) is carried once; its
    positions' entries are the reference's ``{}``.  The multi-token
    prediction modules (``mtp``, a list, unstacked in the reference) are
    carried as they are; the encoder's one scan group (its ``enc`` layers
    stacked) is unstacked the same way."""
    out = {"embed": convert(np_params["embed"], None)}
    for key in ("lm_head", "pos_embed", "shared_block"):
        if key in np_params:
            out[key] = convert(np_params[key], None)
    layers = [None] * cfg.n_layers
    offset = 0
    for g, (unit, k) in enumerate(plan_layer_groups(cfg.layer_program)):
        for r in range(k):
            for j in range(len(unit)):
                layers[offset + r * len(unit) + j] = convert(
                    np_params["groups"][g][j], r)
        offset += k * len(unit)
    out["layers"] = layers
    out["final_norm"] = convert(np_params["final_norm"], None)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        (stacked,), = enc["groups"]
        out["encoder"] = {
            "layers": [convert(stacked, r)
                       for r in range(cfg.encoder.n_layers)],
            "final_norm": convert(enc["final_norm"], None),
            "pos_embed": convert(enc["pos_embed"], None)}
    if "mtp" in np_params:
        out["mtp"] = [convert(m, None) for m in np_params["mtp"]]
    return out


def weight_decay_mask(params: dict) -> dict:
    """Which leaves AdamW decays, as the reference's trainer does: its
    rule is "two or more dimensions", and it stacks every layer's leaves
    along a repeat axis, so each per-layer leaf decays, norm weights and
    vectors included.  The port's per-layer leaves are unstacked: True for
    every leaf under ``"layers"``, the decoder's and the encoder's;
    elsewhere (the embedding, the head, both position tables, the tied
    ``shared_block`` and the ``mtp`` modules, unstacked in the reference
    too, the final norms) two or more dimensions."""
    from repro_torch.optim.tree import tree_map

    def mask(tree):
        return {k: (tree_map(lambda p: True, v) if k == "layers"
                    else mask(v) if k == "encoder"
                    else tree_map(lambda p: p.ndim >= 2, v))
                for k, v in tree.items()}
    return mask(params)


def trainable(params: dict) -> dict:
    """Mark every parameter as requiring a gradient (a trainer's
    parameters; serving's stay as they are).  Returns ``params``."""
    from repro_torch.optim.tree import tree_map
    tree_map(lambda p: p.requires_grad_(True), params)
    return params


def from_reference(np_params: dict, cfg: ModelConfig, device=None,
                   dtype=None) -> dict:
    """The port's parameters from the JAX package's ``init_params`` pytree
    (leaves as numpy arrays or anything ``np.asarray`` takes), on
    ``device`` (``None``: the card, ``RuntimeError`` where none is
    present), each leaf of ``dtype`` or, with ``None``, of its own dtype
    (float32 or bfloat16, bit for bit).

    The reference stores each scan group ``(unit, k)`` of
    :func:`plan_layer_groups` as ``groups[g][j]`` with every leaf stacked
    to a leading extent ``k``: layer ``offset + r·len(unit) + j`` is
    repeat ``r`` of unit position ``j``."""
    device = resolve_device(device)
    return _unstack(np_params, cfg,
                    lambda tree, r: _to_torch(tree, device, index=r,
                                              dtype=dtype))


def from_reference_opt_state(np_state: dict, cfg: ModelConfig,
                             device=None) -> dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    (leaves as numpy arrays or anything ``np.asarray`` takes), the moments
    unstacked like :func:`from_reference`: float32 tensors, or
    :class:`~repro_torch.optim.QTensor` (int8 codes, float32 scales; any
    object with ``codes`` and ``scale``) for 8-bit moments; ``step`` a
    0-d int32 tensor.  On ``device`` (``None``: the card)."""
    from repro_torch.optim.quant import QTensor

    device = resolve_device(device)

    def leaf(x, r):
        if hasattr(x, "codes"):
            return QTensor(*(leaf(np.asarray(getattr(x, f)), r)
                             for f in ("codes", "scale")))
        a = np.asarray(x)
        a = a[r] if r is not None else a
        dt = np.int8 if a.dtype == np.int8 else np.float32
        return torch.from_numpy(np.array(a, dtype=dt)).to(device)

    def convert(tree, r):
        return _to_torch(tree, device, index=r, leaf=leaf)

    return {"m": _unstack(np_state["m"], cfg, convert),
            "v": _unstack(np_state["v"], cfg, convert),
            "step": torch.tensor(int(np.asarray(np_state["step"])),
                                 dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# analytic parameter counts (a copy of the reference's, for every block type)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    gated = cfg.act in ("swiglu", "geglu")

    def attn_count():
        if cfg.mla is not None:
            m, h = cfg.mla, cfg.attn.n_heads
            qk = m.nope_head_dim + m.rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * h * qk
                    + d * m.kv_lora_rank + d * m.rope_head_dim
                    + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                    + h * m.v_head_dim * d)
        a = cfg.attn
        return d * a.head_dim * (a.n_heads * 2 + a.n_kv_heads * 2)

    def mlp_count(f):
        return d * f * (3 if gated else 2)

    def moe_count():
        mo = cfg.moe
        e = mo.top_k if active_only else mo.num_experts
        total = d * mo.num_experts  # router always loaded
        total += e * mo.d_expert * d * (3 if gated else 2)
        if mo.num_shared:
            total += mlp_count(mo.d_expert * mo.num_shared)
        return total

    def ssm_count(kind):
        s, di, dtr = ssm_dims(cfg)
        n, g = s.d_state, s.n_groups
        if kind == "mamba1":
            return (d * 2 * di + s.d_conv * di + di
                    + di * (dtr + 2 * n) + dtr * di + di + di * n + di
                    + di * d)
        heads = di // s.head_dim
        return (d * (2 * di + 2 * g * n + heads)
                + s.d_conv * (di + 2 * g * n) + di + 2 * g * n
                + 3 * heads + di + di * d)

    per_block = {
        "attn": lambda: attn_count() + mlp_count(cfg.d_ff) + 2 * d,
        "local": lambda: attn_count() + mlp_count(cfg.d_ff) + 2 * d,
        "attn_dense": lambda: attn_count() + mlp_count(cfg.d_ff) + 2 * d,
        "attn_moe": lambda: attn_count() + (moe_count() if cfg.moe else 0) + 2 * d,
        "mamba1": lambda: ssm_count("mamba1") + d if cfg.ssm else 0,
        "mamba2": lambda: ssm_count("mamba2") + d if cfg.ssm else 0,
        "shared_attn": lambda: 0,  # counted once below
        "xattn": lambda: 2 * attn_count() + mlp_count(cfg.d_ff) + 3 * d,
        "enc": lambda: attn_count() + mlp_count(cfg.d_ff) + 2 * d,
    }
    total = sum(per_block[b]() for b in cfg.layer_program)
    if "shared_attn" in cfg.layer_program:
        total += attn_count() + mlp_count(cfg.d_ff) + 2 * d
    total += cfg.padded_vocab * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d
    if cfg.pos_embed == "learned":
        total += cfg.max_position * d
    if cfg.is_encdec:
        total += cfg.encoder.n_layers * per_block["enc"]()
        total += cfg.encoder.n_frames * d + d
    if cfg.mtp_depth:
        total += cfg.mtp_depth * (per_block[cfg.layer_program[-1]]() + 2 * d * d + d)
    total += d  # final norm
    return int(total)
