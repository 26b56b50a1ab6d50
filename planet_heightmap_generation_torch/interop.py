"""Carry host state across from numpy into the port's tensors, and
tensors back out to numpy.

The generator has no learned weights; its state is the host prologue —
mesh, plates, super plates, hotspot domes, noise tables and the
projection inputs. :func:`state_from_numpy` takes those products as numpy
arrays (from this package's own prologue or from any other producer of
the same arrays, e.g. the JAX reference) and returns the tensors the
port's device functions consume, so two implementations can compute from
identical inputs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .mesh.build import SphereGraph
from .mesh.device import to_device
from .ops.noise import tables_from_numpy
from .tectonics.coarse import projection_from_numpy

SPHERE_FIELDS = ("n_cells", "n_padded", "pos", "nbr_idx", "nbr_mask",
                 "nbr_dist", "deg", "valid", "triangles", "pole_id")


def to_numpy(x, dtype=None) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array (of
    ``dtype`` where given)."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a if dtype is None else a.astype(dtype, copy=False)


def state_from_numpy(mesh: Mapping[str, np.ndarray],
                     plates: Optional[Mapping[str, np.ndarray]] = None,
                     super_plates: Optional[Mapping[str, np.ndarray]] = None,
                     domes: Optional[Mapping[str, np.ndarray]] = None,
                     noise: Optional[Mapping[str, tuple]] = None,
                     projection: Optional[Mapping[str, np.ndarray]] = None,
                     device="cpu") -> Dict:
    """Tensors of the host prologue products.

    - ``mesh``: the SphereGraph fields (``SPHERE_FIELDS``) → ``graph`` (a
      host SphereGraph) and ``g`` (its DeviceGraph on ``device``). Optional
      ``banded`` (band_off, band_mask, rem_src, rem_dst) and
      ``banded_packed`` (the packed 8-tuple, or None) carry the producer's
      own band decomposition: the split of edges into bands and remainder
      decides the order of sums and of first-best ties, so two
      implementations compare like with like only on the same split.
    - ``plates``: is_ocean, pole, omega, density → ``plates`` =
      (is_ocean bool, pole f32, omega f32, density f32).
    - ``super_plates``: plate_to_super, is_ocean, pole, omega, density
      (already padded) → ``super_plates`` tuple in that order.
    - ``domes``: the build_domes dict → ``domes`` dict of tensors.
    - ``noise``: name → (perm, pm12) → ``noise`` dict of Tables.
    - ``projection``: perm, pm12, perturb_amp, cand_idx, cand_mask,
      points, coarse_plate → ``projection`` tuple for project_kernel.
    """
    out: Dict = {}
    kw = {f: (int(mesh[f]) if f in ("n_cells", "n_padded", "pole_id")
              else np.asarray(mesh[f])) for f in SPHERE_FIELDS}
    if "banded" in mesh:
        kw["_banded"] = tuple(np.asarray(a) for a in mesh["banded"])
        packed = mesh.get("banded_packed")
        kw["_banded_packed"] = (None if packed is None
                                else tuple(np.asarray(a) for a in packed))
    out["graph"] = graph = SphereGraph(**kw)
    out["g"] = to_device(graph, device)

    def t(a, dtype=None):
        # a copy: the producer's arrays may be read-only views
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    if plates is not None:
        out["plates"] = (t(plates["is_ocean"], torch.bool),
                         t(plates["pole"], torch.float32),
                         t(plates["omega"], torch.float32),
                         t(plates["density"], torch.float32))
    if super_plates is not None:
        out["super_plates"] = (
            t(super_plates["plate_to_super"], torch.int32),
            t(super_plates["is_ocean"], torch.bool),
            t(super_plates["pole"], torch.float32),
            t(super_plates["omega"], torch.float32),
            t(super_plates["density"], torch.float32))
    if domes is not None:
        out["domes"] = {k: t(v) for k, v in domes.items()}
    if noise is not None:
        out["noise"] = {k: tables_from_numpy(p, q, device)
                        for k, (p, q) in noise.items()}
    if projection is not None:
        p = projection
        out["projection"] = projection_from_numpy(
            p["perm"], p["pm12"], p["perturb_amp"], p["cand_idx"],
            p["cand_mask"], p["points"], p["coarse_plate"], device)
    return out
