"""Per-layer workload profiles — the substrate of every latency equation.

The port's copy of ``repro/core/profiles.py`` (the VGG-16, transformer,
uniform and random profiles).  Profiles are closed-form host data: numpy
float64 arrays, bit-equal to the reference's.  Per layer index ``i`` in
``[1, I]`` a profile stores *per-layer* (non-cumulative) per-sample
quantities — FP/BP workload,
activation / activation-gradient bytes (Eqs. 5, 9), parameter and optimizer
bytes (Eq. 11) — and exposes cumulative views so that the
"cumulative-difference" trick of Eqs. (3)/(8)/(11) is exact:

  delta^F_k = w[cut_k] - w[cut_{k-1}]   (workload of submodel k, per sample)

In the paper's edge simulator ``w_i`` is in bytes and a node computes
``t = b * kappa_n * delta / f_n`` with ``kappa_n`` in FLOPs/byte (Table II
uses kappa = 1/32).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Per-layer workload profile of an ``I``-layer neural network.

    All arrays have length ``I`` and hold *per-layer* (not cumulative)
    quantities, per single data sample (micro-batch multiplies in later).
    """

    name: str
    fp_work: np.ndarray      # FP workload of layer i (workload units / sample)
    bp_work: np.ndarray      # BP workload of layer i
    act_bytes: np.ndarray    # phi_i: bytes of activations emitted by layer i
    grad_bytes: np.ndarray   # phi'_{i+1}: bytes of act-grads crossing cut at i
    param_bytes: np.ndarray  # beta contribution of layer i
    opt_bytes: np.ndarray    # sigma contribution of layer i (optimizer state)

    def __post_init__(self):
        arrays = (self.fp_work, self.bp_work, self.act_bytes, self.grad_bytes,
                  self.param_bytes, self.opt_bytes)
        n = len(self.fp_work)
        for a in arrays:
            if len(a) != n:
                raise ValueError(f"profile arrays must share length, got {n} vs {len(a)}")
            if np.any(np.asarray(a) < 0):
                raise ValueError("profile quantities must be non-negative")

    @property
    def num_layers(self) -> int:
        return len(self.fp_work)

    # cumulative views, lazily cached on the (frozen) instance: the planner
    # asks for the same cumulative arrays thousands of times per solve
    def _cum(self, key: str, source) -> np.ndarray:
        got = self.__dict__.get(key)
        if got is None:
            got = np.cumsum(source)
            object.__setattr__(self, key, got)
        return got

    def w_cum(self) -> np.ndarray:
        return self._cum("_w_cum", self.fp_work)

    def rho_cum(self) -> np.ndarray:
        return self._cum("_rho_cum", self.bp_work)

    def act_cum(self) -> np.ndarray:
        return self._cum("_act_cum", self.act_bytes)

    def grad_cum(self) -> np.ndarray:
        return self._cum("_grad_cum", self.grad_bytes)

    def param_cum(self) -> np.ndarray:
        return self._cum("_param_cum", self.param_bytes)

    def opt_cum(self) -> np.ndarray:
        return self._cum("_opt_cum", self.opt_bytes)

    def seg_fp(self, lo: int, hi: int) -> float:
        """FP workload per sample of layers (lo, hi] — delta^F of Eq. (3)."""
        w = self.w_cum()
        return float(w[hi - 1] - (w[lo - 1] if lo > 0 else 0.0))

    def seg_bp(self, lo: int, hi: int) -> float:
        r = self.rho_cum()
        return float(r[hi - 1] - (r[lo - 1] if lo > 0 else 0.0))

    def seg_mem_per_sample(self, lo: int, hi: int) -> float:
        """Eq. (11) inner sum over the segment: phi~ + phi'~ + sigma~ + beta."""
        tot = self.__dict__.get("_mem_cum")
        if tot is None:
            tot = (self.act_cum() + self.grad_cum() + self.opt_cum()
                   + self.param_cum())
            object.__setattr__(self, "_mem_cum", tot)
        return float(tot[hi - 1] - (tot[lo - 1] if lo > 0 else 0.0))

    def cut_act_bytes(self, cut: int) -> float:
        """phi at cut layer ``cut`` (1-based): bytes per sample sent forward."""
        return float(self.act_bytes[cut - 1])

    def cut_grad_bytes(self, cut: int) -> float:
        """phi'_(cut+1): bytes per sample of act-grads sent backward at cut."""
        return float(self.grad_bytes[cut - 1])

    def scaled(self, factor: float) -> "ModelProfile":
        """Uniformly scale compute workload (e.g. unit conversion)."""
        return dataclasses.replace(
            self,
            fp_work=self.fp_work * factor,
            bp_work=self.bp_work * factor,
        )


# (kind, out_channels, spatial_out) for CIFAR-10 32x32 inputs.
_VGG16_LAYERS: Sequence[tuple] = (
    ("conv", 64, 32), ("conv", 64, 32),     # block 1 (pool folded into next)
    ("conv", 128, 16), ("conv", 128, 16),   # block 2
    ("conv", 256, 8), ("conv", 256, 8), ("conv", 256, 8),    # block 3
    ("conv", 512, 4), ("conv", 512, 4), ("conv", 512, 4),    # block 4
    ("conv", 512, 2), ("conv", 512, 2), ("conv", 512, 2),    # block 5
    ("fc", 4096, 1), ("fc", 4096, 1), ("fc", 10, 1),         # classifier
)


def vgg16_profile(dtype_bytes: int = 4, optimizer_mult: float = 1.0,
                  work_units: str = "flops") -> ModelProfile:
    """Analytical VGG-16 profile on 32x32 inputs (I = 16 layers, as Table II).

    ``work_units``: "flops" keeps w_i in FLOPs (use kappa = 1);
    "bytes" divides by 32 so the paper's kappa = 1/32 FLOPs/byte recovers
    FLOPs in Eq. (2).
    """
    fp, bp, act, grad, par, opt = [], [], [], [], [], []
    in_c, in_hw = 3, 32
    for kind, out_c, out_hw in _VGG16_LAYERS:
        if kind == "conv":
            # 3x3 conv: 2 * k^2 * Cin * Cout * H * W FLOPs (MACs*2)
            flops = 2.0 * 9 * in_c * out_c * out_hw * out_hw
            params = (9 * in_c * out_c + out_c) * dtype_bytes
            a_bytes = out_c * out_hw * out_hw * dtype_bytes
        else:
            fan_in = in_c * in_hw * in_hw
            flops = 2.0 * fan_in * out_c
            params = (fan_in * out_c + out_c) * dtype_bytes
            a_bytes = out_c * dtype_bytes
        fp.append(flops)
        bp.append(2.0 * flops)          # standard 2x FP cost for BP
        act.append(a_bytes)
        grad.append(a_bytes)            # grads mirror activations
        par.append(params)
        opt.append(params * optimizer_mult)
        in_c, in_hw = out_c, out_hw
    prof = ModelProfile(
        name="vgg16",
        fp_work=np.array(fp), bp_work=np.array(bp),
        act_bytes=np.array(act), grad_bytes=np.array(grad),
        param_bytes=np.array(par), opt_bytes=np.array(opt),
    )
    if work_units == "bytes":
        prof = prof.scaled(32.0)  # w in "bytes" such that kappa=1/32 -> FLOPs
    return prof


# ---------------------------------------------------------------------------
# Transformer-family profiles
# ---------------------------------------------------------------------------

def transformer_layer_flops(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                            seq_len: int, d_head: int | None = None,
                            moe_experts: int = 0, moe_top_k: int = 0,
                            ffn_mult: int = 3) -> float:
    """Per-token FP FLOPs of one transformer layer (matmul-dominant terms).

    ``ffn_mult``: 3 for SwiGLU (gate/up/down), 2 for plain 2-matmul MLP.
    MoE: only ``top_k`` experts are active per token (6*N_active convention).
    """
    d_head = d_head or d_model // n_heads
    qkv = 2 * d_model * (n_heads + 2 * n_kv) * d_head
    attn_out = 2 * n_heads * d_head * d_model
    scores = 2 * 2 * n_heads * d_head * seq_len  # QK^T + AV, per token avg len
    if moe_experts > 0:
        ffn = moe_top_k * ffn_mult * 2 * d_model * d_ff
        router = 2 * d_model * moe_experts
        ffn += router
    else:
        ffn = ffn_mult * 2 * d_model * d_ff
    return float(qkv + attn_out + scores + ffn)


def transformer_profile(name: str, num_layers: int, d_model: int, n_heads: int,
                        n_kv: int, d_ff: int, vocab: int, seq_len: int,
                        dtype_bytes: int = 2, d_head: int | None = None,
                        moe_experts: int = 0, moe_top_k: int = 0,
                        optimizer_mult: float = 2.0, ffn_mult: int = 3,
                        param_dtype_bytes: int = 4) -> ModelProfile:
    """Profile of a decoder-only transformer as a chain of I = L + 2 'layers':

      layer 1      = embedding (lookup; negligible FLOPs, big params)
      layers 2..L+1 = transformer blocks
      layer L+2    = final norm + LM head (2 * d * V FLOPs/token)

    Per-sample quantities are per *sequence* (seq_len tokens), matching the
    paper's per-data-sample accounting.
    """
    d_head = d_head or d_model // n_heads
    blk_flops = transformer_layer_flops(
        d_model, n_heads, n_kv, d_ff, seq_len, d_head, moe_experts, moe_top_k,
        ffn_mult) * seq_len
    if moe_experts > 0:
        blk_params = ((n_heads + 2 * n_kv) * d_head * d_model +
                      n_heads * d_head * d_model +
                      moe_experts * ffn_mult * d_model * d_ff +
                      d_model * moe_experts) * param_dtype_bytes
    else:
        blk_params = ((n_heads + 2 * n_kv) * d_head * d_model +
                      n_heads * d_head * d_model +
                      ffn_mult * d_model * d_ff) * param_dtype_bytes
    act = d_model * seq_len * dtype_bytes  # boundary activation: (seq, d)

    fp = [1e6] + [blk_flops] * num_layers + [2.0 * d_model * vocab * seq_len]
    bp = [2e6] + [2.0 * blk_flops] * num_layers + [4.0 * d_model * vocab
                                                   * seq_len]
    acts = [act] * (num_layers + 1) + [vocab * seq_len * dtype_bytes]
    grads = list(acts)
    params = ([vocab * d_model * param_dtype_bytes] +
              [blk_params] * num_layers +
              [vocab * d_model * param_dtype_bytes])
    opt = [p * optimizer_mult for p in params]
    return ModelProfile(
        name=name,
        fp_work=np.array(fp), bp_work=np.array(bp),
        act_bytes=np.array(acts), grad_bytes=np.array(grads),
        param_bytes=np.array(params, dtype=float),
        opt_bytes=np.array(opt, dtype=float),
    )


def uniform_profile(num_layers: int, fp: float = 1.0, bp: float = 2.0,
                    act: float = 1.0, param: float = 1.0,
                    name: str = "uniform") -> ModelProfile:
    """Degenerate equal-layer profile — handy for tests and analysis."""
    ones = np.ones(num_layers)
    return ModelProfile(
        name=name, fp_work=ones * fp, bp_work=ones * bp,
        act_bytes=ones * act, grad_bytes=ones * act,
        param_bytes=ones * param, opt_bytes=ones * param,
    )


def random_profile(rng: np.random.Generator, num_layers: int,
                   name: str = "random") -> ModelProfile:
    """Random positive profile for property-based tests."""
    def draw(scale):
        return rng.uniform(0.1, 1.0, num_layers) * scale
    return ModelProfile(
        name=name,
        fp_work=draw(1e9), bp_work=draw(2e9),
        act_bytes=draw(1e6), grad_bytes=draw(1e6),
        param_bytes=draw(1e7), opt_bytes=draw(1e7),
    )


def flops_summary(profile: ModelProfile) -> dict:
    return {
        "layers": profile.num_layers,
        "fp_total": float(profile.w_cum()[-1]),
        "bp_total": float(profile.rho_cum()[-1]),
        "param_bytes": float(profile.param_cum()[-1]),
    }
