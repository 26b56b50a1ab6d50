"""The climate slice's banded operations against the JAX jnp functions on
the 2000-cell mesh, inputs made from numpy seeds, and the two climate
kernels' plain versions against a cell-by-cell float32 loop.

Contracts (each with its reason):

- smoothing, plain (F=1, F=2) and masked: rtol 2e-6 / atol 2e-6, the JAX
  package's own smoothing contract (tests/test_sweep_pallas.py:121,126).
  The port divides by deg+1 like the jnp path and adds the band terms in
  band order, then the remainder edges in edge order; XLA fuses the sum
  in its own order (measured on this mesh: max 1.2e-7 absolute).
- diffuse warmth (frozen cells restored every pass): rtol 2e-5 /
  atol 2e-6 (tests/test_sweep_pallas.py:230) (measured max 6.0e-8).
- rain shadow: rtol 1e-5 / atol 1e-6 and the same sign structure
  (tests/test_sweep_pallas.py:205); XLA evaluates the per-edge dot
  products and sums in its own fused order (measured max 1.2e-7).
- least-squares gradients: atol 1e-4 relative to the largest gradient.
  The JAX formula takes each gradient as a difference of neighbour sums
  of f·p and p·pᵀ terms, which cancel in f32, so two f32 evaluations
  that round differently differ by a few ULPs of those sums divided by
  Σde² (measured 1.2e-5 of the largest gradient here, with fields of
  order 1).
- the plain smoothing and rain-shadow sweeps equal a direct per-cell loop
  of the formula in numpy float32 BIT FOR BIT: the same terms in the same
  order, one rounding per operation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from planet_heightmap_generation_tpu.mesh.device import to_device as jdevice
from planet_heightmap_generation_torch import interop
from planet_heightmap_generation_torch.ops import banded as tb
from planet_heightmap_generation_torch.ops import sweep_cuda

import torch_parity as tp


@pytest.fixture(scope="module")
def graphs(tiny_sphere):
    """(JAX DeviceGraph, port DeviceGraph) of the same mesh and the same
    band split."""
    g = interop.state_from_numpy(tp.mesh_fields(tiny_sphere))["g"]
    assert g.rem_src.shape[0] > 0
    return jdevice(tiny_sphere), g


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("case", ["field1", "field2", "masked", "warmth"])
def test_smoothing_matches_jnp(graphs, case):
    from planet_heightmap_generation_tpu.ops.banded import (
        _smooth_field_jnp, _smooth_masked_jnp)
    from planet_heightmap_generation_tpu.climate.temperature import (
        _diffuse_warmth_jnp)
    from planet_heightmap_generation_torch.climate.temperature import (
        _diffuse_ocean_warmth)

    jg, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal(n).astype(np.float32)
    f2 = rng.standard_normal((n, 2)).astype(np.float32)
    mask = (rng.random(n) < 0.6) & g.valid.numpy()
    p_cont = rng.random(n).astype(np.float32)
    rtol = 2e-6
    if case == "field1":
        a = _smooth_field_jnp(jnp.asarray(f1), *jg.bands, 3)
        b = tb.smooth_field_banded(_t(f1), *g.bands, 3)
    elif case == "field2":
        a = _smooth_field_jnp(jnp.asarray(f2), *jg.bands, 3)
        b = tb.smooth_field_banded(_t(f2), *g.bands, 3)
    elif case == "masked":
        a = _smooth_masked_jnp(jnp.asarray(f2), jnp.asarray(mask),
                               *jg.bands, 4)
        b = tb.smooth_masked_banded(_t(f2), _t(mask), *g.bands, 4)
    else:
        rtol = 2e-5
        a = _diffuse_warmth_jnp(jnp.asarray(f2), jnp.asarray(~mask),
                                jnp.asarray(p_cont), *jg.bands, 5)
        b = _diffuse_ocean_warmth(_t(f2), _t(~mask), _t(p_cont), *g.bands,
                                  5)
    assert b.dtype == torch.float32 and b.shape == tuple(a.shape)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol,
                               atol=2e-6)


def _shadow_inputs(g, seed=11):
    n = g.n_padded
    rng = np.random.default_rng(seed)
    elev = (rng.standard_normal(n) * 0.4).astype(np.float32) \
        * g.valid.numpy()
    height_km = np.maximum(0.0, elev) * 6.0
    is_land = (elev > 0) & g.valid.numpy()
    wind3d2 = rng.standard_normal((n, 2, 3)).astype(np.float32) * 0.3
    wdg2 = rng.standard_normal((n, 2)).astype(np.float32) * 0.1
    return elev, height_km.astype(np.float32), is_land, wind3d2, wdg2


def test_rain_shadow_matches_jnp(graphs):
    from planet_heightmap_generation_tpu.climate.precipitation import (
        _rain_shadow2_jnp)
    from planet_heightmap_generation_torch.climate.precipitation import (
        _rain_shadow2)

    jg, g = graphs
    ins = _shadow_inputs(g)
    a = np.asarray(_rain_shadow2_jnp(jg.pos, *map(jnp.asarray, ins),
                                     *jg.bands, 6, 4))
    b = _rain_shadow2(g.pos, *map(_t, ins), *g.bands, 6, 4).numpy()
    assert (np.abs(a) > 0.01).mean() > 0.1
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.sign(np.round(a * 1e4)),
                                  np.sign(np.round(b * 1e4)))


def test_gradients_banded_match_jax(graphs, tiny_sphere):
    from planet_heightmap_generation_tpu.ops.banded import (
        compute_gradients_banded as jgrad)
    from planet_heightmap_generation_tpu.climate.util import geo_frame
    from planet_heightmap_generation_torch.ops.noise import tables, fbm

    jg, g = graphs
    pos = g.pos
    t = tables(5.0)
    field = torch.stack([fbm(t, pos[:, 0] * 2, pos[:, 1] * 2, pos[:, 2] * 2,
                             3),
                         pos[:, 1] * 3 + pos[:, 0]], 1)
    gf = geo_frame(jg.pos)
    ge, gn = jgrad(jg.pos, jnp.asarray(field.numpy()), gf.east, gf.north,
                   *jg.bands)
    pe, pn = tb.compute_gradients_banded(pos, field, _t(gf.east),
                                         _t(gf.north), *g.bands)
    valid = tiny_sphere.valid
    for a, b in ((ge, pe), (gn, pn)):
        a, b = np.asarray(a)[valid], b.numpy()[valid]
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


# ── plain sweeps against a per-cell float32 loop ─────────────────────

def _csr_rows(g):
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, g.n_padded)
    ptr, nbr = ptr.numpy(), nbr.numpy()
    return ptr, nbr, [nbr[ptr[i]:ptr[i + 1]] for i in range(g.n_padded)]


def _neighbours(g, rows, i):
    """Band neighbours in band order, then the remainder row."""
    bits = int(g.band_bits[i]) & 0xFFFFFFFF
    n = g.n_padded
    out = [(i + off) % n for d, off in enumerate(g.band_off)
           if (bits >> d) & 1]
    return out + [int(j) for j in rows[i]]


def _loop_smooth(g, rows, f, c, gate, upd):
    f32 = np.float32
    out = np.empty_like(f)
    for fi in range(f.shape[0]):
        for i in range(f.shape[1]):
            s = f32(0.0)
            for j in _neighbours(g, rows, i):
                if gate is None or gate[j] > 0:
                    s = f32(s + f[fi, j])
            keep = upd is not None and not upd[i] > 0
            out[fi, i] = f[fi, i] if keep else f32(f32(f[fi, i] + s) / c[i])
    return out


def _loop_shadow(g, rows, st, aux, land, retain_s, retain_w):
    f32 = np.float32
    sgn = (f32(-1), f32(-1), f32(1), f32(1))
    retain = (f32(retain_s), f32(retain_s), f32(retain_w), f32(retain_w))
    out = st.copy()

    def dot(a, b):
        return f32(f32(f32(a[0] * b[0]) + f32(a[1] * b[1])) + f32(a[2] * b[2]))

    for i in range(st.shape[1]):
        if not land[i] > 0:
            continue
        wsum = [f32(0)] * 4
        wacc = [f32(0)] * 4
        for j in _neighbours(g, rows, i):
            d = [f32(aux[k, j] - aux[k, i]) for k in range(3)]
            nd = [-x for x in d]
            w = (dot(aux[3:6, j], nd), dot(aux[6:9, j], nd),
                 dot(aux[3:6, i], d), dot(aux[6:9, i], d))
            for c in range(4):
                v = st[c, j]
                if w[c] > 0 and f32(v * sgn[c]) > 0:
                    wsum[c] = f32(wsum[c] + w[c])
                    wacc[c] = f32(wacc[c] + f32(w[c] * v))
        for c in range(4):
            if wsum[c] > 0:
                carried = f32(f32(wacc[c] / max(wsum[c], f32(1e-20)))
                              * retain[c])
                out[c, i] = (min(st[c, i], carried) if c < 2
                             else max(st[c, i], carried))
    return out


@pytest.mark.parametrize("case", ["plain", "masked", "frozen", "shadow"])
def test_plain_sweeps_equal_cell_loop(graphs, case):
    _, g = graphs
    n = g.n_padded
    rng = np.random.default_rng(21)
    ptr, nbr, rows = _csr_rows(g)
    tptr, tnbr = torch.as_tensor(ptr), torch.as_tensor(nbr)
    if case == "shadow":
        elev, _, is_land, wind3d2, wdg2 = _shadow_inputs(g, seed=5)
        st = np.concatenate([wdg2, -wdg2], 1).T.astype(np.float32).copy()
        aux = np.concatenate([g.pos.numpy().T, wind3d2[:, 0].T,
                              wind3d2[:, 1].T]).astype(np.float32)
        land = is_land.astype(np.float32)
        rs, rw = 0.9, 0.8
        got = sweep_cuda.shadow_sweep_plain(
            _t(st), _t(aux), _t(land), g.band_bits, g.band_off, tptr, tnbr,
            rs, rw).numpy()
        want = _loop_shadow(g, rows, st, aux, land, rs, rw)
        before = st
    else:
        f = rng.standard_normal((2, n)).astype(np.float32)
        m = ((rng.random(n) < 0.6) & g.valid.numpy()).astype(np.float32)
        gate = m if case == "masked" else None
        upd = None if case == "plain" else m
        deg = tb.banded_count(g.band_mask, g.rem_src,
                              dtype=torch.float32).numpy()
        c = (deg + 1).astype(np.float32)
        got = sweep_cuda.smooth_sweep_plain(
            _t(f), _t(c), g.band_bits, g.band_off, tptr, tnbr,
            None if gate is None else _t(gate),
            None if upd is None else _t(upd)).numpy()
        want = _loop_smooth(g, rows, f, c, gate, upd)
        before = f
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got, want)


def test_rem_csr_keeps_edge_order(graphs):
    _, g = graphs
    ptr, nbr = tb.rem_csr(g.rem_src, g.rem_dst, g.n_padded)
    src, dst = g.rem_src.numpy(), g.rem_dst.numpy()
    assert ptr.dtype == torch.int32 and nbr.dtype == torch.int32
    assert int(ptr[-1]) == src.shape[0]
    for i in np.unique(src):
        np.testing.assert_array_equal(nbr[ptr[i]:ptr[i + 1]].numpy(),
                                      dst[src == i])
