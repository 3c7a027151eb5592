"""The benchmark's yardstick: the H100's peaks, the kinds of device
kernels, and the operations and bytes of the work a cell does, counted
from its shapes.

Frozen copies, kept with the benchmark so that a change to the program
cannot change how it is measured: the peaks and :func:`kernel_kind` are
``repro_torch/launch/roofline.py``'s (its ``H100_BF16_FLOPS``,
``H100_HBM_BW`` and ``kernel_kind``); the FLOP count is
``repro_torch/launch/dryrun.py::step_flops``' terms corrected where they
overcount (the embedding is a gather, not a matmul; the hybrid's shared
block counts at every application; the output head counts only at the
positions whose logits are used).
"""
from __future__ import annotations

# NVIDIA H100 SXM datasheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name: the port's two LM kernels, the
    cuBLAS matmuls, copies and casts, reductions, the rest."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention (#6)"
    if "ssd_intra" in n:
        return "ssd_intra (#7)"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk", "sm90_")):
        return "matmul (cuBLAS)"
    if any(w in n for w in ("copy", "memcpy", "memset", "fill")):
        return "copies and casts"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


# kinds that are neither a matmul nor attention nor the SSD's kernel
ELEMENTWISE_KINDS = ("copies and casts", "reductions", "elementwise and other")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the work needs on the card: the larger of its
    operations at the bf16 peak and its bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---------------------------------------------------------------------------
# the model's work, from its configuration (a dict of ModelConfig fields)
# ---------------------------------------------------------------------------
def ssm_dims(cfg: dict) -> tuple:
    """(d_inner, heads, head dim, state) of the Mamba-2 blocks."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    return din, din // cfg["ssm_head_dim"], cfg["ssm_head_dim"], cfg["ssm_state"]


def attention_applications(cfg: dict) -> int:
    """How many attention blocks one forward pass runs."""
    if cfg["family"] == "hybrid":
        return cfg["num_layers"] // cfg["shared_attn_every"]
    return 0 if cfg["family"] == "ssm" else cfg["num_layers"]


def mamba_layers(cfg: dict) -> int:
    return cfg["num_layers"] if cfg["family"] in ("ssm", "hybrid") else 0


def _attn_weights(cfg: dict) -> int:
    d, H, KH, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return d * H * hd * 2 + d * KH * hd * 2          # q, o; k, v


def _mlp_weights(cfg: dict) -> int:
    return 3 * cfg["d_model"] * cfg["d_ff"]


def _mamba_weights(cfg: dict) -> int:
    d = cfg["d_model"]
    din, H, _, N = ssm_dims(cfg)
    return d * 2 * din + d * 2 * N + d * H + din * d    # in (z, x), B/C, dt; out


def matmul_weights_per_token(cfg: dict) -> int:
    """The matmul weights one token passes through, the head left out: a
    weight applied k times counts k times."""
    if cfg["family"] == "dense":
        return cfg["num_layers"] * (_attn_weights(cfg) + _mlp_weights(cfg))
    if cfg["family"] == "hybrid":
        return (mamba_layers(cfg) * _mamba_weights(cfg)
                + attention_applications(cfg) * (_attn_weights(cfg) + _mlp_weights(cfg)))
    raise ValueError(f"no FLOP count for the {cfg['family']!r} family")


def attention_fwd_flops(cfg: dict, batch: int, seq: int) -> float:
    """Scores and values of one attention block (causal: half the square)."""
    H, hd = cfg["num_heads"], cfg["head_dim"]
    return 2.0 * batch * seq * seq * H * (2 * hd) * (0.5 if cfg.get("causal", True) else 1.0)


def ssd_fwd_flops(cfg: dict, batch: int, seq: int) -> float:
    """One Mamba-2 block's SSD, as ``dryrun.step_flops`` counts it: the
    intra-chunk products over whole chunks, the chunk states and the
    inter-chunk output."""
    _, H, P, N = ssm_dims(cfg)
    Q = min(cfg["ssm_chunk"], seq)
    return 2.0 * batch * seq * Q * H * (N + P) + 4.0 * batch * seq * H * P * N


def forward_flops(cfg: dict, batch: int, seq: int, head_positions: int) -> float:
    """One forward pass over ``batch`` sequences of ``seq`` tokens: the
    matmuls at 2 FLOPs a weight a token, the head at ``head_positions``
    positions over the real vocabulary, attention and the SSD; the
    embedding counts nothing."""
    tokens = batch * seq
    flops = 2.0 * matmul_weights_per_token(cfg) * tokens
    flops += 2.0 * cfg["d_model"] * cfg["vocab_size"] * head_positions
    if attention_applications(cfg):
        flops += attention_applications(cfg) * attention_fwd_flops(cfg, batch, seq)
    if mamba_layers(cfg):
        flops += mamba_layers(cfg) * ssd_fwd_flops(cfg, batch, seq)
    return flops


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """A prefill: the head at each prompt's last token only."""
    return forward_flops(cfg, batch, seq, head_positions=batch)


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step: three forwards (forward and a backward of twice
    it), the head at every token, the recompute left out."""
    return 3.0 * forward_flops(cfg, batch, seq, head_positions=batch * seq)


# ---------------------------------------------------------------------------
# one kernel call's work
# ---------------------------------------------------------------------------
def attention_call_work(cfg: dict, batch: int, seq: int) -> tuple:
    """(FLOPs, bytes) of one attention forward: bf16 q, k, v read once and
    the bf16 output written once."""
    H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    nbytes = 2 * batch * seq * hd * (2 * H + 2 * KH)
    return attention_fwd_flops(cfg, batch, seq), float(nbytes)


def ssd_intra_call_work(cfg: dict, batch: int, seq: int) -> tuple:
    """(FLOPs, bytes) of one Mamba-2 block's intra-chunk step, over
    ``batch * seq / Q`` chunks of Q tokens: ``C B^T`` once a chunk (one
    group), the causal ``M x`` (half the square) and the chunk states;
    reads bf16 x, B, C and float32 dt and log decays, writes the float32
    intra-chunk output and states and the chunk decays."""
    _, H, P, N = ssm_dims(cfg)
    Q = min(cfg["ssm_chunk"], seq)
    chunks = batch * seq // Q
    flops = chunks * (2.0 * Q * Q * N + Q * Q * H * P + 2.0 * Q * H * P * N)
    reads = chunks * Q * (2 * H * P + 4 * H * 2 + 2 * N * 2)
    writes = chunks * (4 * Q * H * P + 4 * H * P * N + 4 * H)
    return flops, float(reads + writes)
