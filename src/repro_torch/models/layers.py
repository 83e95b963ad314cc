"""Shared neural layers, plain PyTorch: so far the chunked (flash-style)
attention of the model stack and grouped-query KV expansion.

Counterpart of ``repro.models.layers``; the norms, rope, MLP, MoE and the
attention block come with the model stack.
"""
from __future__ import annotations

import torch


def _mask_bias(iq: torch.Tensor, jk: torch.Tensor, *, causal: bool,
               window) -> torch.Tensor:
    """iq: (B, qc), jk: (B, kc) global positions (-1 = padding).  Returns
    the additive bias (B, qc, kc) of 0 / -inf.  ``window`` is an int or a
    0-d integer tensor; <= 0 disables the sliding-window constraint."""
    ok = (jk >= 0)[:, None, :]
    d = iq[:, :, None] - jk[:, None, :]
    if causal:
        ok = ok & (d >= 0)
    ok = ok & ((d < window) | (window <= 0))
    return torch.where(ok, 0.0, -torch.inf).to(torch.float32)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool, window,
                      softcap: float, scale: float, q_chunk: int,
                      kv_chunk: int, band_window: int = 0) -> torch.Tensor:
    """Memory-efficient attention with online softmax.

    q, k, v: (B, S, H, d) with a FLAT, equal head count (callers repeat GQA
    KV heads first); MQA (k/v with a single head) broadcasts in the einsum
    without materializing the repeat.  q_pos: (B, Sq); kv_pos: (B, Skv)
    with -1 marking invalid cache slots.  ``band_window > 0`` (causal
    prefill only) visits just the kv chunks a uniform sliding window of
    that width can reach.  Never materializes more than (B, H, qc, kc)
    logits.  Returns (B, Sq, H, dv) in ``v``'s dtype.
    """
    B, Sq, H, dk = q.shape
    _, Skv, Hkv, dv = v.shape
    mqa = (Hkv == 1 and H > 1)

    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    pq = (-Sq) % qc
    pk = (-Skv) % kc
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, pq))
    q_pos = pad(q_pos, (0, pq), value=-1)
    k = pad(k, (0, 0, 0, 0, 0, pk))
    v = pad(v, (0, 0, 0, 0, 0, pk))
    kv_pos = pad(kv_pos, (0, pk), value=-1)
    nq, nk = q.shape[1] // qc, k.shape[1] // kc

    # The reference pins these chunk stacks to a device mesh; on one device
    # that does nothing (the mesh comes with the distributed port).
    qb = q.reshape(B, nq, qc, H, dk).transpose(0, 1)
    qpb = q_pos.reshape(B, nq, qc).transpose(0, 1)
    kb = k.reshape(B, nk, kc, Hkv, dk).transpose(0, 1)
    vb = v.reshape(B, nk, kc, Hkv, dv).transpose(0, 1)
    kpb = kv_pos.reshape(B, nk, kc).transpose(0, 1)

    # static band for uniform sliding-window prefill: q block i only needs
    # kv blocks within [i*qc - band_window, i*qc + qc); provably masked
    # chunks are skipped (the position masks still guard correctness)
    band = 0
    if band_window > 0 and causal and Sq > 1:
        band = min(-(-band_window // kc) + -(-qc // kc) + 1, nk)

    outs = []
    for iq_blk in range(nq):
        qi, qp = qb[iq_blk], qpb[iq_blk]   # (B, qc, H, dk), (B, qc)
        m = torch.full((B, H, qc), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, dv), dtype=torch.float32,
                          device=q.device)
        blocks = range(nk)
        if band:
            first_needed = (iq_blk * qc - (band_window - 1)) // kc
            start = min(max(first_needed, 0), nk - band)
            blocks = range(start, start + band)
        for j in blocks:
            ki, vi, kp = kb[j], vb[j], kpb[j]
            if mqa:
                s = torch.einsum("bqhd,bkd->bhqk", qi.float(),
                                 ki[:, :, 0].float()) * scale
            else:
                s = torch.einsum("bqhd,bkhd->bhqk", qi.float(),
                                 ki.float()) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            bias = _mask_bias(qp, kp, causal=causal, window=window)
            s = s + bias[:, None, :, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            if mqa:
                pv = torch.einsum("bhqk,bkd->bhqd", p, vi[:, :, 0].float())
            else:
                pv = torch.einsum("bhqk,bkhd->bhqd", p, vi.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))   # (B, qc, H, dv)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, d) -> (B, S, Hkv * n_rep, d), grouped-query expansion."""
    if n_rep == 1:
        return k
    B, S, Hkv, d = k.shape
    k = k[:, :, :, None, :].expand(B, S, Hkv, n_rep, d)
    return k.reshape(B, S, Hkv * n_rep, d)
