"""Device-resident mesh bundle — the static tensors every kernel consumes."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.banded import rem_walk_edges
from .build import SphereGraph


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded mesh tensors on one device.

    Two views of the same adjacency coexist:

    - ``nbr_idx/nbr_mask [NP,K]``: the padded gather form (majority
      smoothing).
    - ``band_off/band_mask/band_bits/rem_src/rem_dst``: the banded form
      (mesh/build.py:build_banded) — neighbour sweeps as masked shifts
      over the Fibonacci spiral ordering plus a small remainder edge list.
      ``band_bits`` packs ``band_mask`` into one int32 word per cell (the
      sweep kernels' input). ``rem_src/rem_dst`` hold only the REAL
      remainder edges: torch scatters have no drop mode, so the padded
      rows of the host list (``rem_src == NP``) are filtered out here once.

    Index tensors are int64 (torch's index type); positions float32.
    """

    pos: torch.Tensor        # [NP, 3] f32
    nbr_idx: torch.Tensor    # [NP, K] i64
    nbr_mask: torch.Tensor   # [NP, K] bool
    valid: torch.Tensor      # [NP] bool
    band_mask: torch.Tensor  # [NP, D] bool
    band_bits: torch.Tensor  # [NP] i32 (bit d = band d)
    rem_src: torch.Tensor    # [M] i64, real edges only
    rem_dst: torch.Tensor    # [M] i64
    n_cells: int
    band_off: tuple

    @property
    def n_padded(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def bands(self) -> tuple:
        """(band_off, band_mask, rem_src, rem_dst) — splat into the
        ops.banded functions: ``banded_min(field, *g.bands)``."""
        return (self.band_off, self.band_mask, self.rem_src, self.rem_dst)


def _expand_graph(npd: int, k: int, n_bands: int, off16, exc_f, exc_v,
                  mask_bits, band_bits, device):
    """Reconstruct the adjacency tensors from the packed host form:
    nbr_idx from int16 offsets (+ the exception list for the pole fan,
    whose offsets overflow 16 bits), masks from bit packs."""
    idx = (torch.arange(npd, dtype=torch.int64, device=device)[:, None]
           + torch.as_tensor(off16, device=device).to(torch.int64))
    idx = idx.reshape(-1)
    idx[torch.as_tensor(exc_f, dtype=torch.int64, device=device)] = \
        torch.as_tensor(exc_v, dtype=torch.int64, device=device)
    idx = idx.reshape(npd, k)
    mask_bits = torch.as_tensor(mask_bits.astype(np.int64), device=device)
    nbr_mask = ((mask_bits[:, None]
                 >> torch.arange(k, device=device)) & 1) > 0
    bb = torch.as_tensor(band_bits.astype(np.int64), device=device)
    band_mask = ((bb[:, None] >> torch.arange(n_bands, device=device)) & 1) > 0
    bits32 = torch.where(bb >= 2 ** 31, bb - 2 ** 32, bb).to(torch.int32)
    return idx, nbr_mask, band_mask, bits32


def to_device(graph: SphereGraph, device="cuda") -> DeviceGraph:
    """Upload the mesh in packed form and expand it on ``device``."""
    npd = graph.n_padded
    k = graph.nbr_idx.shape[1]

    packed = graph.banded_packed
    if packed is not None:
        band_off, band_bits, mask_bits, off16, exc_f, exc_v, \
            rem_src, rem_dst = packed
        n_bands = len(band_off)
    else:
        band_off, band_mask_np, rem_src, rem_dst = graph.banded
        n_bands = band_mask_np.shape[1]
        row = np.arange(npd, dtype=np.int64)[:, None]
        off = graph.nbr_idx.astype(np.int64) - row
        exc = np.abs(off) > 32000
        exc_f = np.flatnonzero(exc).astype(np.int64)
        exc_v = graph.nbr_idx.reshape(-1)[exc_f].astype(np.int32)
        off16 = np.where(exc, 0, off).astype(np.int16)
        mask_bits = np.zeros(npd, np.uint32)
        for s in range(k):
            mask_bits |= graph.nbr_mask[:, s].astype(np.uint32) \
                << np.uint32(s)
        band_bits = np.zeros(npd, np.uint32)
        for d in range(n_bands):
            band_bits |= band_mask_np[:, d].astype(np.uint32) \
                << np.uint32(d)
    assert k <= 32 and n_bands <= 32
    exc_f = np.asarray(exc_f, np.int64)
    exc_v = np.asarray(exc_v, np.int64)
    real = exc_f < npd * k
    idx, nbr_mask, band_mask, bits32 = _expand_graph(
        npd, k, n_bands, off16, exc_f[real], exc_v[real], mask_bits,
        band_bits, device)

    rem_src = np.asarray(rem_src, np.int64)
    rem_dst = np.asarray(rem_dst, np.int64)
    keep = rem_src < npd
    rem_src, rem_dst = rem_src[keep], rem_dst[keep]
    g = DeviceGraph(
        pos=torch.as_tensor(np.asarray(graph.pos, np.float32), device=device),
        nbr_idx=idx,
        nbr_mask=nbr_mask,
        valid=torch.as_tensor(graph.valid, device=device),
        band_mask=band_mask,
        band_bits=bits32,
        rem_src=torch.as_tensor(rem_src, device=device),
        rem_dst=torch.as_tensor(rem_dst, device=device),
        n_cells=int(graph.n_cells),
        band_off=tuple(int(o) for o in band_off),
    )
    # the remainder sums' rows, built from the host copy (no sync)
    rem_walk_edges(g.rem_src, g.rem_dst, host=(rem_src, rem_dst))
    return g
