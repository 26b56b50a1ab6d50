"""The general traffic generator: draws repeat for a seed, differ between
seeds, stay inside the slider ranges, and a ``distinct`` field never
repeats in a run."""

import itertools

import pytest

from portbench.harness import spec, traffic

MIXES = ("new-planet", "sculpt")
BIG = 2 ** 31 + 987_654_321


def _take(seed, mix, n=200):
    return list(itertools.islice(traffic.commands(seed, mix), n))


@pytest.mark.parametrize("name", MIXES)
def test_draws_repeat_for_a_seed(name):
    mix = spec.traffic(name)
    assert _take(BIG, mix) == _take(BIG, mix)
    assert _take(BIG, mix) != _take(BIG + 1, mix)
    cmds = traffic.commands(BIG, mix)
    warm = traffic.warm(mix, cmds)
    n_ext = 2 if mix.get("warm_extremes") else 0
    assert warm[n_ext:] == _take(BIG, mix, mix["warm_calls"])
    assert next(cmds) == _take(BIG, mix, mix["warm_calls"] + 1)[-1]


@pytest.mark.parametrize("name", MIXES)
def test_draws_stay_in_range(name):
    mix = spec.traffic(name)
    cmds = _take(BIG, mix, 2000) + traffic.extremes(mix)
    for cmd in cmds:
        assert set(cmd) == set(mix["set"])
        for k, v in cmd.items():
            r = mix["set"][k]
            assert r["min"] <= v <= r["min"] + r["step"] * (r["count"] - 1)
            pos = (v - r["min"]) / r["step"]
            assert abs(pos - round(pos)) < 1e-6


def test_planet_seeds_never_repeat_in_a_run():
    mix = spec.traffic("new-planet")
    seeds = [c["seed"] for c in _take(BIG, mix, 5000)]
    assert len(set(seeds)) == len(seeds)
    assert all(isinstance(s, int) and 0 <= s < 2 ** 24 for s in seeds)


def test_sculpt_sets_all_six_sliders_over_their_positions():
    mix = spec.traffic("sculpt")
    cmds = _take(BIG, mix, 3000)
    assert {k for c in cmds for k in c} == {
        "smoothing", "glacial_erosion", "hydraulic_erosion",
        "thermal_erosion", "ridge_sharpening", "terrain_warp"}
    for k in mix["set"]:
        assert len({c[k] for c in cmds}) == 21
    top, bottom = traffic.extremes(mix)
    assert set(top.values()) == {1.0} and set(bottom.values()) == {0.0}
