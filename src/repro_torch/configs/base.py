"""Config substrate — the port of ``repro/configs/base.py``, for every
family (``dense``: the decoder-only transformer; ``moe``: the same with
experts; ``vlm``: its backbone; ``ssm``: RWKV6; ``hybrid``: Jamba's Mamba
and attention layers; ``audio``: Whisper): the assigned input shapes and
their cells, the per-layer FLOP helpers, the planner's per-arch workload
profile, the parameter estimate (which the trainer's policy reads,
``launch/steps.py::default_optimizer_name``) and the stand-ins of every
model input, cache and parameter as meta-device tensors (shape and dtype,
no memory): :func:`input_specs`, :func:`cache_specs`, :func:`param_specs`.

``count_params`` is the reference's estimate from that profile (fp32
parameter bytes / 4), not the model's parameter count: it counts every
attention layer's q/k/v/o as (H + 2 KV) hd d x 2 and every RWKV layer as
6 d^2 + 2 d d_ff and every Mamba layer as 3 d d_inner, leaves out norms,
biases, LoRAs and the Mamba block's small projections, counts the head
whether tied or not, and walks only the decoder of an encoder-decoder
(qwen3-0.6b: 810,287,104 against 596,049,920 real parameters; rwkv6-1.6b:
1,577,058,304 against 1,580,795,904; command-r-35b: 33,051,115,520 against
30,283,538,432).  A layer counts its experts when the reference's
``is_moe_layer`` says so (the transformer puts them in every layer; the
published configs set ``moe_every`` 1 there, where the two agree; ROADMAP
Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.profiles import ModelProfile
from repro_torch.models.common import ArchConfig
from repro_torch.models.mamba import d_inner, dt_rank

#: the reference's families, every one ported
PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str             # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SHAPE_NAMES = tuple(SHAPES)


def supports_shape(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention: ssm (and hybrid) only."""
    if shape == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def runnable_cells(configs: dict) -> list:
    """Every (arch id, shape name) pair that ``supports_shape`` allows."""
    return [(a, s) for a in configs for s in SHAPE_NAMES
            if supports_shape(configs[a], s)]


# ---------------------------------------------------------------------------
# Meta-device stand-ins of every model input, cache and parameter
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """{name: meta tensor} for the step function of this cell (the
    reference's ShapeDtypeStructs).  train / prefill: a batch dict (and
    ``patch_embeds`` for a VLM, ``frames`` for audio, in the compute
    type); decode: {'token', 'pos'} (the cache comes from
    :func:`cache_specs`)."""
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    i32, f = torch.int32, cfg.compute_dtype
    if sp.kind == "decode":
        return {"token": _spec((B, 1), i32), "pos": _spec((), i32)}
    batch = {"tokens": _spec((B, S), i32)}
    if sp.kind == "train":
        batch["labels"] = _spec((B, S), i32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _spec((B, cfg.patch_tokens, cfg.d_model), f)
    if cfg.family == "audio":
        batch["frames"] = _spec((B, cfg.encoder_frames, cfg.d_model), f)
    return batch


def cache_specs(cfg: ArchConfig, shape_name: str, *, batch: int = None,
                seq_len: int = None) -> dict:
    """The KV cache / recurrent state of this cell's batch and length (or
    of ``batch`` / ``seq_len`` when given), as each family's
    ``make_cache`` (RWKV6's ``init_state``) builds it on the meta device:
    the family knows which of its leaves has a length axis."""
    from repro_torch.models import jamba, rwkv6, transformer, whisper
    sp = SHAPES[shape_name]
    B, T = batch or sp.global_batch, seq_len or sp.seq_len
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, B, META)
    make = {"hybrid": jamba.make_cache,
            "audio": whisper.make_cache}.get(cfg.family,
                                             transformer.make_cache)
    return make(cfg, B, T, META)


def _model_class(cfg: ArchConfig):
    from repro_torch.models import jamba, rwkv6, transformer, whisper
    _check_family(cfg)
    return {"ssm": rwkv6.RWKV6, "hybrid": jamba.Jamba,
            "audio": whisper.Whisper}.get(cfg.family,
                                          transformer.Transformer)


def _stack_specs(specs: list) -> torch.Tensor:
    return _spec((len(specs),) + tuple(specs[0].shape), specs[0].dtype)


def param_specs(cfg: ArchConfig) -> dict:
    """The reference's parameter tree (the names ``params_to_jax`` gives:
    per-layer parameters stacked on a leading axis, the experts under
    ``layers["moe"]``) with meta tensors of its shapes and dtypes: the
    model is built on the meta device and its named parameters nested by
    shape alone."""
    from repro_torch.models.common import nest_layers
    model = _model_class(cfg)(cfg, device=META)
    return nest_layers({n: p.detach() for n, p in model.named_parameters()},
                       _stack_specs)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# Workload profiles for the planner (per-layer FLOPs / boundary bytes)
# ---------------------------------------------------------------------------

def _attn_layer_flops(cfg: ArchConfig, seq: int) -> float:
    hd = cfg.head_dim
    qkv = 2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv) * hd
    out = 2 * cfg.n_heads * hd * cfg.d_model
    scores = 2 * 2 * cfg.n_heads * hd * (seq / 2)   # causal average
    return float((qkv + out + scores) * seq)


def _ffn_layer_flops(cfg: ArchConfig, seq: int) -> float:
    if cfg.moe_experts:
        per_tok = (cfg.moe_top_k * cfg.ffn_mult * 2 * cfg.d_model * cfg.d_ff
                   + 2 * cfg.d_model * cfg.moe_experts)
    else:
        per_tok = cfg.ffn_mult * 2 * cfg.d_model * cfg.d_ff
    return float(per_tok * seq)


def _mamba_layer_flops(cfg: ArchConfig, seq: int) -> float:
    di, ds, dtr = d_inner(cfg), cfg.mamba_d_state, dt_rank(cfg)
    per_tok = (2 * cfg.d_model * 2 * di + 2 * di * (dtr + 2 * ds)
               + 2 * dtr * di + 10 * di * ds + 2 * di * cfg.d_model)
    return float(per_tok * seq)


def _rwkv_layer_flops(cfg: ArchConfig, seq: int) -> float:
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    per_tok = (5 * 2 * d * d        # r/k/v/g/o projections
               + 2 * d * 64 * 2     # decay LoRA
               + 4 * d * hd         # WKV state update + readout
               + 2 * 2 * d * ff + 2 * d * d)   # channel mix
    return float(per_tok * seq)


def arch_profile(cfg: ArchConfig, shape_name: str = "train_4k",
                 dtype_bytes: int = 2, optimizer_mult: float | None = None
                 ) -> ModelProfile:
    """Per-layer (embedding + blocks + head) profile for the MSP planner.

    ``optimizer_mult`` (sigma bytes per param byte): None picks the same
    policy as the trainer — AdamW (2.0 = 8 B/param) below 100B params,
    Adafactor (~0.025) above (launch/steps.py).
    """
    _check_family(cfg)
    if optimizer_mult is None:
        probe = arch_profile(cfg, shape_name, dtype_bytes, 2.0)
        n = float(probe.param_cum()[-1]) / 4.0
        optimizer_mult = 0.025 if n >= 100e9 else 2.0
    seq = SHAPES[shape_name].seq_len
    act = float(cfg.d_model * seq * dtype_bytes)
    fp, bp, acts, grads, params, opt = [], [], [], [], [], []

    def add(flops, pbytes, a=act):
        fp.append(flops)
        bp.append(2.0 * flops)
        acts.append(a)
        grads.append(a)
        params.append(float(pbytes))
        opt.append(float(pbytes) * optimizer_mult)

    pd = 4  # param bytes (fp32 masters)
    add(1e6, cfg.vocab * cfg.d_model * pd)          # embedding
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            fl = _attn_layer_flops(cfg, seq)
            pb = (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim * cfg.d_model \
                * pd * 2
        elif kind == "mamba":
            fl = _mamba_layer_flops(cfg, seq)
            pb = 3 * cfg.d_model * d_inner(cfg) * pd
        else:  # rwkv
            fl = _rwkv_layer_flops(cfg, seq)
            pb = 6 * cfg.d_model * cfg.d_model * pd
        if kind != "rwkv":
            if cfg.is_moe_layer(i):
                fl += _ffn_layer_flops(cfg, seq)
                pb += cfg.moe_experts * cfg.ffn_mult * cfg.d_model \
                    * cfg.d_ff * pd
            else:
                fl += _ffn_layer_flops(
                    dataclasses.replace(cfg, moe_experts=0), seq)
                pb += cfg.ffn_mult * cfg.d_model * cfg.d_ff * pd
        else:
            pb += 2 * cfg.d_model * cfg.d_ff * pd
        add(fl, pb)
    add(2.0 * cfg.d_model * cfg.vocab * seq,
        cfg.vocab * cfg.d_model * pd,
        a=float(cfg.vocab * seq * dtype_bytes))     # head
    return ModelProfile(
        name=cfg.name, fp_work=np.array(fp), bp_work=np.array(bp),
        act_bytes=np.array(acts), grad_bytes=np.array(grads),
        param_bytes=np.array(params), opt_bytes=np.array(opt))


def count_params(cfg: ArchConfig) -> int:
    """The reference's parameter estimate (see the module docstring)."""
    prof = arch_profile(cfg)
    return int(prof.param_cum()[-1] // 4)
