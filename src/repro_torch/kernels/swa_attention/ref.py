"""Plain PyTorch versions of the sliding-window attention kernel.

Both take the model layout: q (B, S, H, Dh), k/v (B, S, Hkv, Dh), query
head h reading kv head h // (H // Hkv). Key k is valid for query q iff
``q - window < k <= q``. Scores, softmax and the value sums are float32
(as in the Pallas kernel, which casts its tiles to float32); the output is
cast to q's dtype.

``swa_attention_plain`` is the kernel's twin: the band recurrence of
``repro.models.attention.causal_attention`` (one query chunk at a time
against its ``window + chunk`` keys, so memory stays O(S (window + chunk))),
for any S. It is what a CPU tensor runs and what the kernel is held
against on the card. ``swa_attention_ref`` materializes the full (S, S)
mask, like JAX's ``kernels/swa_attention/ref.py``; tests only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
Q_CHUNK = 256  # queries per step of the band recurrence


def _softcap(s: torch.Tensor, cap) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def swa_attention_plain(q, k, v, *, window: int,
                        cap: float | None = None) -> torch.Tensor:
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    # kv padded on the left so every chunk's band is an in-bounds slice
    kp = F.pad(k.float(), (0, 0, 0, 0, window, 0))
    vp = F.pad(v.float(), (0, 0, 0, 0, window, 0))
    q5 = q.float().reshape(B, S, Hkv, G, Dh)
    out = torch.empty_like(q)
    for start in range(0, S, Q_CHUNK):
        n = min(Q_CHUNK, S - start)
        band = window + n  # padded rows [start, start+band) == [start-window, ...)
        qpos = start + torch.arange(n, device=q.device)
        kpos = start - window + torch.arange(band, device=q.device)
        valid = ((kpos[None, :] <= qpos[:, None])
                 & (kpos[None, :] > qpos[:, None] - window)
                 & (kpos[None, :] >= 0))
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5[:, start:start + n],
                         kp[:, start:start + band])
        s = _softcap(s * scale, cap)
        s = torch.where(valid, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.sum(p, dim=-1)
        acc = torch.einsum("bhgqk,bkhd->bqhgd", p, vp[:, start:start + band])
        o = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        out[:, start:start + n] = o.reshape(B, n, H, Dh).to(q.dtype)
    return out


def swa_attention_ref(q, k, v, *, window: int, cap: float | None = None):
    """Naive full-mask oracle (tests only)."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    kx = k.float().repeat_interleave(G, dim=2)
    vx = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * (Dh ** -0.5)
    s = _softcap(s, cap)
    pos = torch.arange(S, device=q.device)
    valid = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)
