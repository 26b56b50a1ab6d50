"""Gather-form graph kernels over the padded [NP, K] neighbour arrays, and
the per-cell uint32 hash."""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def majority_smooth(labels, nbr_idx, nbr_mask, protect, num_passes: int = 3,
                    first_threshold: float = 0.4, threshold: float = 0.5):
    """Majority-vote boundary smoothing of an integer label field
    (reference js/plates.js:264-286): a cell adopts the most common
    neighbour label when its vote count exceeds ``deg * threshold`` (0.4
    on pass 0, then 0.5). Synchronous passes; ties go to the first slot
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax``)."""
    deg = nbr_mask.sum(1)
    pair = nbr_mask[:, None, :] & nbr_mask[:, :, None]
    for p in range(num_passes):
        thr = first_threshold if p == 0 else threshold
        nl = labels[nbr_idx]                                   # [N, K]
        same = (nl[:, :, None] == nl[:, None, :]) & pair       # [N, K, K]
        counts = torch.where(nbr_mask, same.sum(2), -1)
        best_slot = torch.argmax(counts, dim=1, keepdim=True)
        best_count = torch.gather(counts, 1, best_slot)[:, 0]
        best_label = torch.gather(nl, 1, best_slot)[:, 0]
        adopt = (best_count > deg * thr) & (~protect) & (deg > 0)
        labels = torch.where(adopt, best_label, labels)
    return labels


def mul_u32(h, c: int):
    """(h * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (c split into 16-bit halves)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash01(idx, salt: int):
    """Deterministic per-cell hash → [0,1) (uint32 mix emulated in int64),
    used to randomize BFS fronts like the reference's Knuth-hash priority
    noise (js/terrain-post.js:96-105)."""
    h = (idx.to(torch.int64) + (int(salt) & _U32)) & _U32
    h = mul_u32(h, 2654435761)
    h = mul_u32(h ^ (h >> 16), 0x45D9F3B)
    h = h ^ (h >> 16)
    return (h % (1 << 24)).to(torch.float32) / float(1 << 24)
