"""Plain PyTorch reference of the benchmark's decoder configurations.

A Qwen1.5-style dense decoder (QKV bias, SwiGLU) and a Qwen3-MoE-style
decoder (softmax top-k routing over all experts, the top-k weights
renormalised, SwiGLU experts), written from the published architecture
and nothing of the program under test.  Pre-norm RMSNorm, rotary
embeddings on the two halves of each head, grouped-query attention with
a causal mask, untied output head.  Qwen3 publishes an RMSNorm on each
query and key head, which the program does not run; the reference
follows the program there, and the configuration file lists the
departure.

One sequence is one stream from position 0: full causal attention over
its own tokens, no cache, no batching, no padding.  Weights are the
nested dict the benchmark draws (``embed`` (V, d), ``unembed`` (d, V),
``final_norm``, and ``layers`` stacked over the layer axis: ``ln1``,
``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``,
``bk``, ``bv``}, and ``mlp`` {``w_gate``, ``w_up``, ``w_down``} or
``moe`` {``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, f), ``w_down``
(E, f, d)}); they are read in float32 a layer at a time, so the
reference fits beside them.

``precision="f32"`` computes in float32 with TF32 off.  ``"fp8"`` is the
control: every product with a weight takes its inputs rounded to
float8 e4m3, the weight scaled per output column and the activation per
row (the router, stated in float32, and attention stay float32).
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0      # largest finite float8 e4m3 number
Q_BLOCK = 512        # query rows per attention block
TOKEN_BLOCK = 16384  # rows per MoE dispatch block


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to the largest e4m3 number), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (n, k) float32 times w (k, m), read in float32."""
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, pos, theta):
    """x (T, heads, hd) float32; pos (T,) int."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v):
    """Causal attention of one sequence: q (T, nh, hd), k, v (T, nkv, hd)."""
    T, nh, hd = q.shape
    g = nh // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) / math.sqrt(hd)
        mask = keys[None, :e] > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v[:e])
    return out


def _attn_block(cfg, p, x, pos, lens, precision):
    """Self-attention over the concatenated streams x (N, d): one
    projection for all, attention within each stream."""
    N = x.shape[0]
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = _mm(x, p["wq"], precision)
    k = _mm(x, p["wk"], precision)
    v = _mm(x, p["wv"], precision)
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    theta = cfg["rope_theta"]
    q = _rope(q.view(N, nh, hd), pos, theta)
    k = _rope(k.view(N, nkv, hd), pos, theta)
    v = v.view(N, nkv, hd)
    o = torch.cat([_attention(qs, ks, vs) for qs, ks, vs in
                   zip(q.split(lens), k.split(lens), v.split(lens))])
    return _mm(o.reshape(N, nh * hd), p["wo"], precision)


def _swiglu(x, wg, wu, wd, precision):
    g = _mm(x, wg, precision)
    return _mm(torch.nn.functional.silu(g) * _mm(x, wu, precision), wd,
               precision)


def _moe(cfg, p, x, precision):
    """Every row's top-k experts by softmax over all router logits, the
    k weights renormalised to sum to 1, each expert's SwiGLU weighted and
    summed (in choice order, so the sum does not depend on scheduling)."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.empty_like(x)
    for s in range(0, x.shape[0], TOKEN_BLOCK):
        xb, eb = x[s:s + TOKEN_BLOCK], top_e[s:s + TOKEN_BLOCK]
        ys = torch.zeros(xb.shape[0], k, x.shape[1], device=x.device)
        for e in torch.unique(eb).tolist():
            rows, slot = (eb == e).nonzero(as_tuple=True)
            ys[rows, slot] = _swiglu(xb[rows], p["w_gate"][e], p["w_up"][e],
                                     p["w_down"][e], precision)
        w = top_p[s:s + TOKEN_BLOCK]
        acc = ys[:, 0] * w[:, :1]
        for j in range(1, k):
            acc = acc + ys[:, j] * w[:, j:j + 1]
        out[s:s + TOKEN_BLOCK] = acc
    return out


def _layer_params(tree, i):
    return {key: (_layer_params(val, i) if isinstance(val, dict) else val[i])
            for key, val in tree.items()}


@torch.no_grad()
def logits_at(cfg: dict, weights: dict, streams, rows,
              precision: str = "f32"):
    """Logits of each stream at the given rows.

    ``streams``: token-id sequences (each from position 0); ``rows``: for
    each stream the positions whose next-token logits are wanted.
    Returns one (len(rows[i]), V) float32 tensor per stream."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        emb = weights["embed"]
        dev = emb.device
        eps = cfg["rms_norm_eps"]
        lens = [len(s) for s in streams]
        h = emb[torch.as_tensor([t for s in streams for t in s],
                                dtype=torch.long, device=dev)].float()
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        ffn = "moe" if "moe" in weights["layers"] else "mlp"
        for i in range(cfg["num_hidden_layers"]):
            p = _layer_params(weights["layers"], i)
            x = _rms(h, p["ln1"], eps)
            h = h + _attn_block(cfg, p["attn"], x, pos, lens, precision)
            x = _rms(h, p["ln2"], eps)
            if ffn == "moe":
                h = h + _moe(cfg, p["moe"], x, precision)
            else:
                m = p["mlp"]
                h = h + _swiglu(x, m["w_gate"], m["w_up"], m["w_down"],
                                precision)
        out = []
        for hs, r in zip(h.split(lens), rows):
            sel = hs[torch.as_tensor(r, dtype=torch.long, device=dev)]
            out.append(_mm(_rms(sel, weights["final_norm"], eps),
                           weights["unembed"], precision))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
