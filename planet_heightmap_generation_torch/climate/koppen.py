"""Köppen climate classification — the JAX package's climate/koppen.py
decision table in torch (worldbuilding-pasta band methodology): two-season
proxies, hemisphere-aware local seasons, temperature bands (EF/ET/A/C/D),
the aridity split (desert/steppe, h/k) and the s/w/f + a/b/c/d sub-letter
lookup. IDs and colours match the reference table (js/koppen.js:19-51)."""

from __future__ import annotations

import torch

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


def _pick(letter, names):
    """The class id of ``names[letter]`` per cell (letter clipped)."""
    ids = torch.tensor([_ID[c] for c in names], dtype=torch.int64,
                       device=letter.device)
    return ids[torch.clamp(letter, 0, len(names) - 1)]


def classify_koppen(elev, t_summer, t_winter, p_summer, p_winter):
    """Per-cell Köppen class id, int32 (js/koppen.js:67-288)."""
    ts = -45 + torch.clamp(t_summer, 0.0, 1.0) * 90
    tw = -45 + torch.clamp(t_winter, 0.0, 1.0) * 90
    t_hot = torch.maximum(ts, tw)
    t_cold = torch.minimum(ts, tw)
    t_ann = (ts + tw) / 2
    t_shoulder = t_hot - (t_hot - t_cold) * (2.0 / 6.0)

    local_summer_is_sim = ts >= tw
    ps = torch.clamp(p_summer, min=0.0) * 1000
    pw = torch.clamp(p_winter, min=0.0) * 1000
    p_ann = ps + pw
    p_sum_local = torch.where(local_summer_is_sim, ps, pw)
    p_win_local = torch.where(local_summer_is_sim, pw, ps)
    ps_month = p_sum_local / 6
    pw_month = p_win_local / 6
    p_dry = torch.minimum(ps_month, pw_month)

    # aridity threshold (js/koppen.js:167-176)
    summer_frac = torch.where(
        p_ann > 0, p_sum_local / torch.clamp(p_ann, min=1e-20), 0.5)
    p_thresh = torch.where(
        summer_frac >= 0.7, 20 * t_ann + 280,
        torch.where(summer_frac <= 0.3, 20 * t_ann, 20 * t_ann + 140))
    p_thresh = torch.clamp(p_thresh, min=0.0)

    is_hot = t_ann >= 18

    # s/w/f pattern (js/koppen.js:203-211): 0=f, 1=s, 2=w
    local_summer_drier = p_sum_local < p_win_local
    is_s = local_summer_drier & (ps_month < 50) & (ps_month < pw_month / 2)
    is_w = (~local_summer_drier) & (pw_month < ps_month / 10)
    pattern = torch.where(is_s, 1, torch.where(is_w, 2, 0))

    # a/b/c/d letter (js/koppen.js:219-227)
    letter = torch.where(
        t_hot >= 22, 0,
        torch.where(t_shoulder >= 10, 1, torch.where(t_cold >= -38, 2, 3)))

    # band A subtypes (js/koppen.js:229-249)
    a_id = torch.where(
        p_dry >= 60, _ID["Af"],
        torch.where(p_ann >= 25 * (100 - p_dry), _ID["Am"], _ID["Aw"]))

    # band C: missing combos (C?d) fall back to Cfb (js/koppen.js:257-263)
    c_f = _pick(letter, ("Cfa", "Cfb", "Cfc"))
    c_s = _pick(letter, ("Csa", "Csb", "Csc"))
    c_w = _pick(letter, ("Cwa", "Cwb", "Cwc"))
    c_id = torch.where(pattern == 1, c_s, torch.where(pattern == 2, c_w, c_f))
    c_id = torch.where(letter == 3, _ID["Cfb"], c_id)

    # band D: the full 12-class grid exists
    d_f = _pick(letter, ("Dfa", "Dfb", "Dfc", "Dfd"))
    d_s = _pick(letter, ("Dsa", "Dsb", "Dsc", "Dsd"))
    d_w = _pick(letter, ("Dwa", "Dwb", "Dwc", "Dwd"))
    d_id = torch.where(pattern == 1, d_s, torch.where(pattern == 2, d_w, d_f))

    # arid B overrides A/C/D (after the polar short-circuit)
    bw = torch.where(is_hot, _ID["BWh"], _ID["BWk"])
    bs = torch.where(is_hot, _ID["BSh"], _ID["BSk"])
    b_id = torch.where(p_ann < p_thresh * 0.5, bw, bs)

    # band selection (js/koppen.js:123-147)
    non_polar = torch.where(
        p_ann < p_thresh, b_id,
        torch.where(t_cold >= 18, a_id,
                    torch.where(t_cold >= 0, c_id, d_id)))
    out = torch.where(t_hot < 0, _ID["EF"],
                      torch.where(t_hot < 10, _ID["ET"], non_polar))
    return torch.where(elev <= 0, _ID["Ocean"], out).to(torch.int32)
