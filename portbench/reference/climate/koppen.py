"""Köppen climate classification — vectorized decision table.

Re-design of reference js/koppen.js (worldbuilding-pasta band methodology):
two-season proxies (Thot/Tcold/Tann/Tshoulder), hemisphere-aware local
seasons, temperature bands (EF/ET/A/C/D), the aridity threshold split
(desert/steppe, h/k), and the s/w/f + a/b/c/d sub-letter lookup. All
branches are jnp.where selections over [N] arrays; IDs and colors match the
reference table (js/koppen.js:19-51) exactly.
"""

from __future__ import annotations

import numpy as np
from ..backend import jax
from ..backend import jnp

KOPPEN_CODES = [
    "Ocean", "Af", "Am", "Aw", "BWh", "BWk", "BSh", "BSk",
    "Cfa", "Cfb", "Cfc", "Csa", "Csb", "Csc", "Cwa", "Cwb", "Cwc",
    "Dfa", "Dfb", "Dfc", "Dfd", "Dsa", "Dsb", "Dsc", "Dsd",
    "Dwa", "Dwb", "Dwc", "Dwd", "ET", "EF",
]
_ID = {c: i for i, c in enumerate(KOPPEN_CODES)}

KOPPEN_COLORS = [
    [0.29, 0.44, 0.65], [0.00, 0.00, 1.00], [0.00, 0.47, 1.00],
    [0.27, 0.67, 0.98], [1.00, 0.00, 0.00], [1.00, 0.59, 0.59],
    [0.96, 0.65, 0.00], [1.00, 0.86, 0.39], [0.78, 1.00, 0.31],
    [0.39, 1.00, 0.31], [0.20, 0.78, 0.00], [1.00, 1.00, 0.00],
    [0.78, 0.78, 0.00], [0.59, 0.59, 0.00], [0.59, 1.00, 0.59],
    [0.39, 0.78, 0.39], [0.20, 0.59, 0.20], [0.00, 1.00, 1.00],
    [0.22, 0.78, 1.00], [0.00, 0.49, 0.49], [0.00, 0.27, 0.37],
    [0.90, 0.50, 1.00], [0.70, 0.35, 0.85], [0.50, 0.20, 0.65],
    [0.35, 0.10, 0.45], [0.67, 0.69, 1.00], [0.43, 0.47, 0.78],
    [0.29, 0.31, 0.78], [0.20, 0.00, 0.53], [0.70, 0.70, 0.70],
    [0.41, 0.41, 0.41],
]


@jax.jit
def classify_koppen(elev, t_summer, t_winter, p_summer, p_winter):
    """Per-cell Köppen class id (js/koppen.js:67-288)."""
    ts = -45 + jnp.clip(t_summer, 0.0, 1.0) * 90
    tw = -45 + jnp.clip(t_winter, 0.0, 1.0) * 90
    t_hot = jnp.maximum(ts, tw)
    t_cold = jnp.minimum(ts, tw)
    t_ann = (ts + tw) / 2
    t_shoulder = t_hot - (t_hot - t_cold) * (2.0 / 6.0)

    local_summer_is_sim = ts >= tw
    ps = jnp.maximum(0.0, p_summer) * 1000
    pw = jnp.maximum(0.0, p_winter) * 1000
    p_ann = ps + pw
    p_sum_local = jnp.where(local_summer_is_sim, ps, pw)
    p_win_local = jnp.where(local_summer_is_sim, pw, ps)
    ps_month = p_sum_local / 6
    pw_month = p_win_local / 6
    p_dry = jnp.minimum(ps_month, pw_month)

    # aridity threshold (js/koppen.js:167-176)
    summer_frac = jnp.where(p_ann > 0, p_sum_local / jnp.maximum(p_ann, 1e-20), 0.5)
    p_thresh = jnp.where(
        summer_frac >= 0.7, 20 * t_ann + 280,
        jnp.where(summer_frac <= 0.3, 20 * t_ann, 20 * t_ann + 140))
    p_thresh = jnp.maximum(0.0, p_thresh)

    is_hot = t_ann >= 18

    # s/w/f pattern (js/koppen.js:203-211)
    local_summer_drier = p_sum_local < p_win_local
    is_s = local_summer_drier & (ps_month < 50) & (ps_month < pw_month / 2)
    is_w = (~local_summer_drier) & (pw_month < ps_month / 10)
    # pattern index: 0=f, 1=s, 2=w
    pattern = jnp.where(is_s, 1, jnp.where(is_w, 2, 0))

    # a/b/c/d letter (js/koppen.js:219-227)
    letter = jnp.where(
        t_hot >= 22, 0,
        jnp.where(t_shoulder >= 10, 1, jnp.where(t_cold >= -38, 2, 3)))

    # band A subtypes (js/koppen.js:229-249)
    a_id = jnp.where(
        p_dry >= 60, _ID["Af"],
        jnp.where(p_ann >= 25 * (100 - p_dry), _ID["Am"], _ID["Aw"]))

    # band C: C + pattern + letter; missing combos (Cs with letter d, Cw with
    # d, C?d) fall back to Cfb (js/koppen.js:257-263)
    c_f = jnp.choose(jnp.clip(letter, 0, 2),
                     np.array([_ID["Cfa"], _ID["Cfb"], _ID["Cfc"]]), mode="clip")
    c_s = jnp.choose(jnp.clip(letter, 0, 2),
                     np.array([_ID["Csa"], _ID["Csb"], _ID["Csc"]]), mode="clip")
    c_w = jnp.choose(jnp.clip(letter, 0, 2),
                     np.array([_ID["Cwa"], _ID["Cwb"], _ID["Cwc"]]), mode="clip")
    c_id = jnp.where(pattern == 1, c_s, jnp.where(pattern == 2, c_w, c_f))
    c_id = jnp.where(letter == 3, _ID["Cfb"], c_id)  # no C?d classes

    # band D: full 12-class grid exists
    d_f = jnp.choose(letter, np.array(
        [_ID["Dfa"], _ID["Dfb"], _ID["Dfc"], _ID["Dfd"]]), mode="clip")
    d_s = jnp.choose(letter, np.array(
        [_ID["Dsa"], _ID["Dsb"], _ID["Dsc"], _ID["Dsd"]]), mode="clip")
    d_w = jnp.choose(letter, np.array(
        [_ID["Dwa"], _ID["Dwb"], _ID["Dwc"], _ID["Dwd"]]), mode="clip")
    d_id = jnp.where(pattern == 1, d_s, jnp.where(pattern == 2, d_w, d_f))

    # arid B overrides A/C/D (applies after polar short-circuit)
    bw = jnp.where(is_hot, _ID["BWh"], _ID["BWk"])
    bs = jnp.where(is_hot, _ID["BSh"], _ID["BSk"])
    b_id = jnp.where(p_ann < p_thresh * 0.5, bw, bs)

    # band selection (js/koppen.js:123-147)
    non_polar = jnp.where(
        p_ann < p_thresh, b_id,
        jnp.where(t_cold >= 18, a_id, jnp.where(t_cold >= 0, c_id, d_id)))
    out = jnp.where(
        t_hot < 0, _ID["EF"],
        jnp.where(t_hot < 10, _ID["ET"], non_polar))

    return jnp.where(elev <= 0, _ID["Ocean"], out).astype(jnp.int32)
