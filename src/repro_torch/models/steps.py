"""Step factories (port of ``repro/models/steps.py``): the training step
and the serving steps.

Each factory closes over the static config and returns a function that
runs eagerly.  The serving steps take (params, cache, ...) and update the
cache in place (the reference jits these and donates the cache).  The
training step takes (params, opt_state, batch) and returns new trees.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.tree import flatten, tree_map, unflatten


def loss_and_grad(cfg, params, batch):
    """``((loss, metrics), grads)`` of :func:`models.model.lm_loss`, as
    ``jax.value_and_grad(..., has_aux=True)`` gives them: the gradients
    (``torch.autograd.grad`` over the tree's leaves) in the parameters'
    dtypes, everything detached.  ``params`` is left as it is."""
    flat = flatten(params)
    paths = [p for p, _ in flat]
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in flat]
    with torch.enable_grad():
        loss, metrics = M.lm_loss(cfg, unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(paths, grads)


def make_train_step(cfg, optimizer, *, micro_batches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``micro_batches`` > 1 accumulates gradients in the step: every batch
    entry's rows are split as ``x.reshape(m, B // m, ...)``, the
    micro-batches' gradients summed in float32 in order and divided by
    ``m``, and their losses and metrics averaged.  With one micro-batch
    the gradients stay in the parameters' dtypes, as in the reference.
    Metrics: ``nll``, ``aux``, ``loss``, ``grad_norm``, ``lr``.
    """

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = loss_and_grad(cfg, params, batch)
        else:
            m = micro_batches
            mbatch = {k: shardctx.split_dim(x, 0, (m, x.shape[0] // m))
                      for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            losses, metricses = [], []
            for i in range(m):
                # (on a mesh each micro-batch is sharded over the batch
                # axes again)
                (loss_i, metrics_i), g = loss_and_grad(
                    cfg, params, {k: shardctx.constrain_batch_dim(x[i], 0)
                                  for k, x in mbatch.items()})
                grads = tree_map(lambda a, gg: a + gg.float(), grads, g)
                losses.append(loss_i)
                metricses.append(metrics_i)
            grads = tree_map(lambda g: g / m, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([mt[k] for mt in metricses]).mean()
                       for k in metricses[0]}
        params, opt_state, opt_m = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, **opt_m)
        return params, opt_state, metrics

    return train_step


def make_loss_fn(cfg):
    """(params, batch) -> (loss, metrics): :func:`models.model.lm_loss`."""
    def loss_fn(params, batch):
        return M.lm_loss(cfg, params, batch)
    return loss_fn


def make_prefill_step(cfg):
    """(params, cache, tokens, aux_inputs=None) -> (logits_last, cache).

    tokens: (B, T).  Fills the KV or SSM cache (and, given the vlm's
    image embeds or the audio family's frames in ``aux_inputs``, the
    cross cache) and returns last-position logits.  An SSM has no mask:
    the batch's prompts share one length.
    """

    def prefill(params, cache, tokens, aux_inputs=None):
        B, T = tokens.shape
        pos = M.default_positions(B, T, device=tokens.device)
        logits, cache, _, _ = M.forward(cfg, params, tokens, pos, cache=cache,
                                        aux_inputs=aux_inputs)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg, *, window: int = 0):
    """(params, cache, token (B,1), pos (B,1)) -> (logits (B,V), cache)."""

    def decode(params, cache, token, pos):
        logits, cache, _, _ = M.forward(cfg, params, token, pos, cache=cache,
                                        window=window)
        return logits[:, -1], cache

    return decode


def make_verify_step(cfg, *, window: int = 0):
    """The paper's partial prefill (§4.5) returning the full (B, C, V)
    logits: the legacy/debug step the unfused scheduler path uses."""

    def verify(params, cache, tokens, pos):
        logits, cache, _, _ = M.forward(cfg, params, tokens, pos, cache=cache,
                                        window=window)
        return logits, cache

    return verify


def fused_verify_epilogue(logits, targets, sel_idx, top_k: int,
                          with_dists: bool = True):
    """Device-resident verification epilogue (the hot-path contract).

    logits: (B, C, V); targets: (B, C) token ids whose probability the
    verifier needs (-1 = none); sel_idx: (B, R) local row indices of the
    rows the verifier consumes (-1 = unused).  Every vocab-sized
    reduction touches only the R selected rows.

    Returns ``(token_id (B, R) int32, p_target (B, R) f32, topk_idx
    (B, R, K) int32, topk_val (B, R, K) f32)``; ``with_dists=False``
    returns zeros for all but ``token_id``.
    """
    B, C, V = logits.shape
    R = sel_idx.shape[1]
    selc = sel_idx.clamp(0, C - 1).long()
    rows = torch.gather(logits, 1, selc[..., None].expand(B, R, V)).float()
    token_id = rows.argmax(-1).to(torch.int32)
    dev = logits.device
    if not with_dists:
        return (token_id, torch.zeros((B, R), dtype=torch.float32, device=dev),
                torch.zeros((B, R, top_k), dtype=torch.int32, device=dev),
                torch.zeros((B, R, top_k), dtype=torch.float32, device=dev))
    tsel = torch.gather(targets, 1, selc)
    lse = torch.logsumexp(rows, dim=-1)
    tgt = tsel.clamp(0, V - 1).long()
    p_t = torch.exp(torch.gather(rows, -1, tgt[..., None])[..., 0] - lse)
    p_t = torch.where((tsel >= 0) & (sel_idx >= 0), p_t, 0.0)
    # top-k on logits == top-k on probs (softmax is monotone)
    tkl, topk_idx = torch.topk(rows, top_k, dim=-1)
    topk_val = torch.exp(tkl - lse[..., None])
    return token_id, p_t, topk_idx.to(torch.int32), topk_val


def make_cloud_verify_step(cfg, *, window: int = 0, top_k: int = 8,
                           with_dists: bool = True):
    """Fused serving step: partial-prefill forward + verification epilogue
    + last-valid-row gather.

    (params, cache, tokens (B,C), pos (B,C), targets (B,C), sel_idx (B,R),
     last_local (B,)) ->
        ((token_id, p_target, topk_idx, topk_val, last_row (B,V) f32),
         cache)
    """

    def step(params, cache, tokens, pos, targets, sel_idx, last_local):
        logits, cache, _, _ = M.forward(cfg, params, tokens, pos, cache=cache,
                                        window=window)
        tok, p_t, tk_i, tk_v = fused_verify_epilogue(
            logits, targets, sel_idx, top_k, with_dists=with_dists)
        B, _, V = logits.shape
        last = torch.gather(logits, 1, last_local.long()[:, None, None]
                            .expand(B, 1, V))[:, 0]
        return (tok, p_t, tk_i, tk_v, last.float()), cache

    return step


def make_cloud_decode_step(cfg, *, window: int = 0, top_k: int = 8):
    """Fused decode step: one token per slot, returns only the argmax id
    and the top-k sampling support (never the (B, V) logits).

    (params, cache, token (B,1), pos (B,1)) ->
        ((token_id (B,), topk_idx (B,K), topk_val (B,K)), cache)
    """

    def step(params, cache, token, pos):
        logits, cache, _, _ = M.forward(cfg, params, token, pos, cache=cache,
                                        window=window)
        row = logits[:, -1].float()
        tok = row.argmax(-1).to(torch.int32)
        tkl, tk_i = torch.topk(row, top_k, dim=-1)
        lse = torch.logsumexp(row, dim=-1)
        tk_v = torch.exp(tkl - lse[..., None])
        return (tok, tk_i.to(torch.int32), tk_v), cache

    return step


def make_device_draft_step(cfg):
    """Device-side SLM forward for a draft chunk: logits, the updated
    cache and the paper's importance scores.  Importance needs the
    attention matrix, so the path is the naive one or the fused
    attn_importance kernel (``attn_impl="pallas"``)."""
    dev_cfg = cfg if cfg.attn_impl == "pallas" else cfg.replace(
        attn_impl="naive")

    def draft(params, cache, tokens, pos):
        logits, cache, imp, _ = M.forward(dev_cfg, params, tokens, pos,
                                          cache=cache, return_importance=True)
        return logits, cache, imp

    return draft
