"""Loss functions (counterpart of ``repro.models.losses``). The chunked
cross-entropy never materialises (B, T, V) logits."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def chunked_cross_entropy(x: Tensor, embed_table: Tensor, labels: Tensor,
                          *, chunk: int, mask: Tensor | None = None,
                          z_loss: float = 1e-4):
    """x: (B, T, d) final hidden states; labels: (B, T) integers.

    Mean token CE over T in chunks: a (B, chunk, V) f32 logits slab is
    live a chunk, plus ``z_loss`` times the mean squared log-partition.
    ``mask``: 1.0 = count this token.
    """
    b, t, d = x.shape
    chunk = max(1, min(chunk, t))
    while t % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    table = embed_table.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    tot, cnt, zacc = zero, zero, zero
    for i in range(t // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = torch.einsum("bcd,vd->bcv", x[:, sl].to(torch.float32),
                              table)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        mi = mask[:, sl]
        tot = tot + ((lse - gold) * mi).sum()
        cnt = cnt + mi.sum()
        zacc = zacc + ((lse ** 2) * mi).sum()
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt + z_loss * zacc / cnt, {"ce": tot / cnt, "tokens": cnt}
