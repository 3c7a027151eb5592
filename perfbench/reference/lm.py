"""Plain float32 reference of the benchmark's language models.

The equations of the two model families the benchmark runs, written from
their published descriptions and the configuration files beside them, in
plain ``torch`` operations on float32 tensors.  Where the configured model
departs from the published one (each departure a key of the
configuration's ``reduced``), these are the configured equations.  Nothing here imports the
program under test: the benchmark makes the weights and the tokens and
hands the same to both sides, and this module works out again everything
the program derives from them.

- ``dense``: pre-norm decoder blocks (RMSNorm scaled by ``1 + w``), GQA
  attention with rotary positions (the two halves of each head rotated),
  causal softmax attention scaled by ``1/sqrt(head_dim)``, a SwiGLU MLP
  (``silu(x W_gate) * (x W_up)``, then ``W_down``), a final RMSNorm and an
  untied output head.
- ``hybrid``: Mamba-2 blocks [arXiv:2405.21060] (in-projection to z, x, B,
  C and dt; a causal depthwise convolution and SiLU on x and on B/C;
  ``dt = softplus(dt_raw + dt_bias)``, ``A = -exp(A_log)``; the SSD
  recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t
  + D x_t``, evaluated chunk by chunk with the state-space duality; the
  output gated by ``silu(z)``, RMSNorm, out-projection), with one
  attention + MLP block whose weights are shared, applied to the hidden
  state after every ``shared_attn_every`` Mamba blocks (its heads may be
  wider than ``d_model / num_heads``).

Each sequence is computed on its own (the rows of a batch do not
interact), and the weights of a layer are cast to float32 only while that
layer runs, so the reference fits beside the program's weights.  With
``Precision.FP8`` every matrix product takes its operands rounded to fp8
(e4m3 forward, e5m2 gradients, one scale a tensor): the benchmark's
control, which the comparison has to refuse.

TF32 must be off while this runs (:func:`float32_matmuls`): on the H100 a
float32 matmul otherwise runs in TF32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# the embedding and the head are padded to a multiple of this many rows
# (vocabularies of 8,192 and more); the padded logits are never a token
VOCAB_PAD = 512
# query rows of one block of attention scores
Q_BLOCK = 1024
# tokens a chunk of the SSD evaluation
SSD_CHUNK = 256
# cache entries with a row a position (the others: one a layer)
POSITIONAL = ("k", "v", "sk", "sv")


# ---------------------------------------------------------------------------
# the weights' layout
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight tensor: its shape, its storage dtype and how the
    benchmark draws it (``normal`` times ``scale``, ``A_log``,
    ``dt_bias``, ``ones``)."""
    shape: tuple
    dtype: torch.dtype
    init: str = "normal"
    scale: float = 0.02


def padded_vocab(cfg: dict) -> int:
    V = cfg["vocab_size"]
    return V if V < 8192 else -(-V // VOCAB_PAD) * VOCAB_PAD


def ssm_dims(cfg: dict) -> tuple:
    """(d_inner, heads, head dim, state, conv width) of the Mamba-2 blocks."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    return din, din // cfg["ssm_head_dim"], cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_conv"]


def _attn_layout(cfg: dict, lead: tuple) -> dict:
    d, H, KH, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    out_scale = 0.02 / math.sqrt(2 * cfg["num_layers"])
    bf = torch.bfloat16
    return {"wq": Leaf(lead + (d, H * hd), bf), "wk": Leaf(lead + (d, KH * hd), bf),
            "wv": Leaf(lead + (d, KH * hd), bf), "wo": Leaf(lead + (H * hd, d), bf, scale=out_scale)}


def _mlp_layout(cfg: dict, lead: tuple) -> dict:
    d, ff = cfg["d_model"], cfg["d_ff"]
    out_scale = 0.02 / math.sqrt(2 * cfg["num_layers"])
    return {"w_gateup": Leaf(lead + (d, 2, ff), torch.bfloat16),
            "w_down": Leaf(lead + (ff, d), torch.bfloat16, scale=out_scale)}


def _norm(shape) -> Leaf:
    return Leaf(tuple(shape), torch.float32, "normal", 0.1)


def layout(cfg: dict) -> dict:
    """The weight tree the benchmark makes for ``cfg``: per-layer weights
    stacked on a leading ``[num_layers]`` axis under ``blocks``; the
    hybrid's shared block under ``shared``.  Matrices are bfloat16, norms
    and the SSM's dynamics float32."""
    family, d, nl = cfg["family"], cfg["d_model"], cfg["num_layers"]
    if cfg.get("attn", "gqa") != "gqa" or cfg.get("fused_qkv") or not cfg.get("fused_gate_up", True):
        raise ValueError("the reference covers GQA attention with split q/k/v and a fused gate/up")
    vp = padded_vocab(cfg)
    tree: dict = {"embed": Leaf((vp, d), torch.bfloat16, scale=1.0)}
    blocks: dict = {"ln1": _norm((nl, d))}
    if family == "dense":
        blocks["attn"] = _attn_layout(cfg, (nl,))
        blocks["ln2"] = _norm((nl, d))
        blocks["mlp"] = _mlp_layout(cfg, (nl,))
    elif family == "hybrid":
        din, H, P, N, W = ssm_dims(cfg)
        if cfg.get("ssm_groups", 1) != 1:
            raise ValueError("the reference covers one B/C group")
        bf = torch.bfloat16
        blocks["mamba"] = {
            "w_zx": Leaf((nl, d, 2 * din), bf), "w_bc": Leaf((nl, d, 2 * N), bf),
            "w_dt": Leaf((nl, d, H), bf),
            "dt_bias": Leaf((nl, H), torch.float32, "dt_bias"),
            "A_log": Leaf((nl, H), torch.float32, "A_log"),
            "D": Leaf((nl, H), torch.float32, "ones"),
            "conv_x": Leaf((nl, W, din), bf, scale=0.2), "conv_bc": Leaf((nl, W, 2 * N), bf, scale=0.2),
            "norm": _norm((nl, din)),
            "w_out": Leaf((nl, din, d), bf, scale=0.02 / math.sqrt(2 * nl)),
        }
        tree["shared"] = {"ln1": _norm((d,)), "attn": _attn_layout(cfg, ()), "ln2": _norm((d,)),
                          "mlp": _mlp_layout(cfg, ())}
    else:
        raise ValueError(f"no reference for the {family!r} family")
    tree["blocks"] = blocks
    tree["final_norm"] = _norm((d,))
    tree["lm_head"] = Leaf((d, vp), torch.bfloat16)
    return tree


def walk(tree: dict, path: tuple = ()):
    """(path, value) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, path + (k,))
        else:
            yield path + (k,), v


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------
def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (an fp8 type) under one scale that maps
    its largest magnitude to the type's largest value; float32 out."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Precision:
    """How the reference multiplies matrices: float32, or (the control)
    with fp8 operands."""
    FLOAT32 = "float32"
    FP8 = "fp8"

    def __init__(self, name: str = FLOAT32):
        if name not in (self.FLOAT32, self.FP8):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b if self.name == self.FLOAT32 else _Fp8MatMul.apply(a, b)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the block (float32 matmuls in float32), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ---------------------------------------------------------------------------
# layers (one sequence: x [S, d], float32)
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x [S, H, D]: position t rotates the pair (x_i, x_{i + D/2}) by
    ``t * theta^(-i / (D/2))``."""
    S, _, D = x.shape
    half = D // 2
    inv = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, causal: bool, prec: Precision):
    """Softmax attention: q [S, H, D], k/v [S, KH, D] (query head h reads
    key head ``h // (H // KH)``) -> [S, H, D], in blocks of query rows."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [H, S, D]
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        kv = q1 if causal else S
        s = prec.mm(qh[:, q0:q1], kh[:, :kv].transpose(1, 2)) / math.sqrt(D)
        if causal:
            allowed = torch.arange(q0, q1, device=q.device)[:, None] >= torch.arange(kv, device=q.device)
            s = s.masked_fill(~allowed, float("-inf"))
        out.append(prec.mm(torch.softmax(s, dim=-1), vh[:, :kv]))
    return torch.cat(out, dim=1).transpose(0, 1)


def attention_block(x, p, cfg, prec, kv=None):
    """The attention sublayer's output (before the residual); appends the
    rotated keys and the values to ``kv`` when given."""
    S = x.shape[0]
    H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = rope(prec.mm(x, p["wq"]).view(S, H, hd), cfg["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).view(S, KH, hd), cfg["rope_theta"])
    v = prec.mm(x, p["wv"]).view(S, KH, hd)
    if kv is not None:
        kv.append((k.detach(), v.detach()))
    a = attention(q, k, v, cfg.get("causal", True), prec)
    return prec.mm(a.reshape(S, H * hd), p["wo"])


def swiglu(x, p, prec):
    w = p["w_gateup"]
    gu = prec.mm(x, w.reshape(w.shape[0], -1))
    ff = w.shape[-1]
    return prec.mm(F.silu(gu[:, :ff]) * gu[:, ff:], p["w_down"])


def dense_layer(x, p, cfg, prec, kv=None):
    """x + attention, then + the MLP, each of the normed input: a dense
    decoder layer, and the hybrid's shared block."""
    eps = cfg["norm_eps"]
    x = x + attention_block(rmsnorm(x, p["ln1"], eps), p["attn"], cfg, prec, kv)
    return x + swiglu(rmsnorm(x, p["ln2"], eps), p["mlp"], prec)


def causal_conv(u, w):
    """Depthwise causal convolution: u [S, C], w [W, C];
    ``out[t] = sum_i w[i] u[t - (W-1) + i]``, zeros before the start."""
    W, S = w.shape[0], u.shape[0]
    up = F.pad(u, (0, 0, W - 1, 0))
    return sum(up[i:i + S] * w[i] for i in range(W))


def ssd(x, dt, A, B, C, chunk: int = SSD_CHUNK):
    """The SSM ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = h_t C_t`` from ``h_0 = 0``, by chunks (the state-space
    duality): x [S, H, P], dt [S, H], A [H], B/C [S, N] -> (y [S, H, P],
    the final state [H, P, N])."""
    S, H, P = x.shape
    N = B.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    c = S // Q
    X = (x * dt[..., None]).view(c, Q, H, P)
    a = (dt * A).view(c, Q, H).permute(2, 0, 1)               # [H, c, Q]
    acs = torch.cumsum(a, dim=-1)
    Bc, Cc = B.view(c, Q, N), C.view(c, Q, N)
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    seg = torch.where(below, acs[..., :, None] - acs[..., None, :], float("-inf"))
    Wm = (Cc @ Bc.transpose(1, 2))[None] * torch.exp(seg)     # [H, c, Q, Q]
    y_diag = torch.einsum("hcls,cshp->clhp", Wm, X)
    to_end = torch.exp(acs[..., -1:] - acs).permute(1, 2, 0)   # [c, Q, H]
    states = torch.einsum("csn,cshp->chpn", Bc, X * to_end[..., None])
    chunk_decay = torch.exp(acs[..., -1])                      # [H, c]
    h = torch.zeros(H, P, N, dtype=x.dtype, device=x.device)
    before = []
    for j in range(c):
        before.append(h)
        h = h * chunk_decay[:, j, None, None] + states[j]
    before = torch.stack(before)                               # [c, H, P, N]
    y_off = torch.einsum("cln,chpn->clhp", Cc, before) * torch.exp(acs).permute(1, 2, 0)[..., None]
    return (y_diag + y_off).reshape(S, H, P), h


def mamba_layer(x, p, cfg, prec, state=None):
    """x + the Mamba-2 block of x.  With ``state`` (a dict) the serving
    state after the sequence is stored in it: the last W-1 inputs of each
    convolution (``conv_x``, ``conv_bc``) and the SSM's final state
    (``ssm``)."""
    S = x.shape[0]
    din, H, P, N, W = ssm_dims(cfg)
    h = rmsnorm(x, p["ln1"], cfg["norm_eps"])
    m = p["mamba"]
    zx = prec.mm(h, m["w_zx"])
    z, xi_raw = zx[:, :din], zx[:, din:]
    bc_raw = prec.mm(h, m["w_bc"])
    dt = F.softplus(prec.mm(h, m["w_dt"]) + m["dt_bias"])
    xi = F.silu(causal_conv(xi_raw, m["conv_x"]))
    bc = F.silu(causal_conv(bc_raw, m["conv_bc"]))
    y, final = ssd(xi.view(S, H, P), dt, -torch.exp(m["A_log"]), bc[:, :N], bc[:, N:])
    y = y + xi.view(S, H, P) * m["D"][:, None]
    y = rmsnorm(y.reshape(S, din) * F.silu(z), m["norm"], cfg["norm_eps"])
    if state is not None:
        hist = lambda u: F.pad(u, (0, 0, max(0, W - 1 - S), 0))[-(W - 1):]  # noqa: E731
        state.update(conv_x=hist(xi_raw.detach()), conv_bc=hist(bc_raw.detach()), ssm=final.detach())
    return x + prec.mm(y, m["w_out"])


def head(x, p, cfg, prec):
    """Logits over the real vocabulary: x [T, d] -> [T, vocab_size]."""
    x = rmsnorm(x, p["final_norm"], cfg["norm_eps"])
    return prec.mm(x, p["lm_head"][:, :cfg["vocab_size"]])


def schedule(cfg: dict) -> list:
    """The blocks in order: ("layer", i), and for the hybrid ("shared", j)
    after every ``shared_attn_every`` layers (the j-th application)."""
    out = []
    every = cfg.get("shared_attn_every", 0) if cfg["family"] == "hybrid" else 0
    for i in range(cfg["num_layers"]):
        out.append(("layer", i))
        if every and i % every == every - 1:
            out.append(("shared", i // every))
    return out


def _block(kind, x, p, cfg, prec, kv=None, state=None):
    if kind == "layer" and cfg["family"] == "hybrid":
        return mamba_layer(x, p, cfg, prec, state)
    return dense_layer(x, p, cfg, prec, kv)


# ---------------------------------------------------------------------------
# serving: one prompt's last-token logits and cache
# ---------------------------------------------------------------------------
def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def _layer_slice(tree: dict, i: int) -> dict:
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i].float() for k, v in tree.items()}


@torch.no_grad()
def prefill(weights: dict, tokens: torch.Tensor, cfg: dict, prec: Precision = Precision()):
    """One prompt ``tokens`` [S] through the model: (last-token logits
    [vocab_size], the cache entries) with ``weights`` in their storage
    dtypes (each layer cast to float32 while it runs).  Cache entries, in
    the program's names: dense ``k``/``v`` [L, S, KH, hd] (rotated keys);
    hybrid ``conv_x``/``conv_bc`` [L, W-1, C], ``ssm`` [L, H, P, N] and the
    shared block's ``sk``/``sv`` [applications, S, KH, hd]."""
    x = weights["embed"][tokens].float()
    kv, states = [], []
    shared = _f32(weights["shared"]) if "shared" in weights else None
    for kind, i in schedule(cfg):
        st = {} if kind == "layer" and cfg["family"] == "hybrid" else None
        p = shared if kind == "shared" else _layer_slice(weights["blocks"], i)
        x = _block(kind, x, p, cfg, prec, kv, st)
        if st is not None:
            states.append(st)
        del p
    logits = head(x[-1:], {k: weights[k].float() for k in ("final_norm", "lm_head")}, cfg, prec)[0]
    cache = {}
    names = ("sk", "sv") if cfg["family"] == "hybrid" else ("k", "v")
    if kv:
        cache[names[0]] = torch.stack([k for k, _ in kv])
        cache[names[1]] = torch.stack([v for _, v in kv])
    for name in ("conv_x", "conv_bc", "ssm"):
        if states:
            cache[name] = torch.stack([s[name] for s in states])
    return logits, cache


# ---------------------------------------------------------------------------
# training: the loss, its gradient and AdamW
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamW:
    """Decoupled weight decay [Loshchilov & Hutter], the gradient clipped
    to a global norm first, the learning rate warmed up linearly over
    ``warmup_steps``."""
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def master_weights(weights: dict) -> tuple:
    """(float32 copies of the weights, a stacked weight split into a list
    of one leaf a layer; [(name, leaf, the weight it came from)] with a
    stacked weight's layer i named ``blocks.<path>[i]``)."""
    named = []

    def split(tree, path):
        out = {}
        for k, v in tree.items():
            name = ".".join(path + (k,))
            if isinstance(v, dict):
                out[k] = split(v, path + (k,))
            elif path[:1] == ("blocks",):
                out[k] = [v[i].detach().float().clone().requires_grad_() for i in range(v.shape[0])]
                named.extend((f"{name}[{i}]", t, v[i]) for i, t in enumerate(out[k]))
            else:
                out[k] = v.detach().float().clone().requires_grad_()
                named.append((name, out[k], v))
        return out

    return split(weights, ()), named


def _layer_of(master: dict, i: int) -> dict:
    return {k: _layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in master.items()}


def sequence_loss(master: dict, tokens, labels, cfg, prec: Precision):
    """The summed cross-entropy of one sequence (tokens, labels [S]), each
    block recomputed in the backward (``torch.utils.checkpoint``)."""
    x = master["embed"][tokens]
    shared = master.get("shared")
    for kind, i in schedule(cfg):
        p = shared if kind == "shared" else _layer_of(master["blocks"], i)
        flat = [t for _, t in walk(p)]

        def run(x, *leaves, kind=kind, p=p):
            it = iter(leaves)
            q = _rebuild(p, it)
            return _block(kind, x, q, cfg, prec)

        x = checkpoint(run, x, *flat, use_reentrant=False)
    logits = head(x, master, cfg, prec)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).sum()


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}


def train(weights: dict, batches: list, cfg: dict, opt: AdamW, prec: Precision = Precision()):
    """AdamW steps from ``weights`` (the benchmark's tree, storage dtypes)
    on ``batches`` (each (tokens, labels) [B, S], every label a token):
    the loss is the mean cross-entropy of the batch.  Each leaf is kept in
    float32 holding a value of its storage dtype: an update is computed in
    float32 and rounded to that dtype, as the weights are stored.

    Returns {"loss": [per step], "grad": {leaf: norm of the first step's
    gradient as the update takes it (clipped)}, "change": {leaf: norm of
    its change over the steps}} by :func:`master_weights`' names."""
    master, named = master_weights(weights)
    moments = {n: (torch.zeros_like(t), torch.zeros_like(t)) for n, t, _ in named}
    losses, first_grad = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        total = tokens.numel()
        loss = 0.0
        for b in range(tokens.shape[0]):
            part = sequence_loss(master, tokens[b], labels[b], cfg, prec) / total
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {n: t.grad for n, t, _ in named}
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            clip = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
            if first_grad is None:
                first_grad = {n: float(torch.linalg.vector_norm(g) * clip) for n, g in grads.items()}
            lr = opt.lr * min(step / opt.warmup_steps, 1.0)
            bc1, bc2 = 1.0 - opt.beta1 ** step, 1.0 - opt.beta2 ** step
            for n, t, w0 in named:
                g = grads[n] * clip
                m, v = moments[n]
                m.mul_(opt.beta1).add_(g, alpha=1 - opt.beta1)
                v.mul_(opt.beta2).add_(g * g, alpha=1 - opt.beta2)
                new = t - lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * t)
                t.copy_(new.to(w0.dtype).float())
                t.grad = None
        del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(t - w0.float())) for n, t, w0 in named}
    return {"loss": losses, "grad": first_grad, "change": change}
