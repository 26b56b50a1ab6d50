"""The port's pointer-doubling sums against the JAX package, bit for bit,
on forests made with numpy from a seed (CPU tensors: the plain version of
the accumulate kernel).

Contracts, all EXACT:

- ``flow_accumulation`` (int32 counts) equals the JAX f32 counts;
- ``downstream_accumulate`` equals the JAX while_loop of scatter-adds: each
  target's adds in source order, the jnp scatter-add's order on the CPU;
- the ice flow (``pointer_accumulate`` at 22 rounds, no stop at the sink)
  equals the JAX glacial step's 22-step ``lax.scan``
  (erosion/glacial.py:69-79), also where values hold -0.0 and every
  pointer reaches the sink early: the port stops once a round has run and
  no pointer is left off the sink, and the rounds it skips would add
  +0.0 to values that hold no -0.0;
- ``ordered_index_sum`` equals ``jnp.zeros(n+1).at[idx].add(vals)[:n]`` at
  F = 1 and 3;
- ``accumulate_relax_plain`` equals the Python loops it replaced (a
  scatter-add or count per round, with their stop rules) and returns the
  rounds they ran.

Forests: chains (one path through every cell), pits (random drainage with
roots), sink-heavy (90 % of pointers at the sink), a star (over 1,000
sources onto one cell) and a chain whose round cap binds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — one torch thread per test process

from planet_heightmap_generation_torch.ops import sweep_cuda
from planet_heightmap_generation_torch.ops.banded import (
    ordered_index_sum, pointer_accumulate)

N = 3000
KINDS = ["chains", "pits", "sink_heavy", "star", "cap_binds"]


def forest(kind: str, seed: int = 0):
    """(receivers [N] int64, -1 at roots; rounds cap, 0 = the default)."""
    rng = np.random.default_rng(seed)
    i = np.arange(N)
    if kind in ("chains", "cap_binds"):
        order = rng.permutation(N)
        rcv = np.full(N, -1)
        rcv[order[:-1]] = order[1:]
        return rcv, (3 if kind == "cap_binds" else 0)
    if kind == "pits":
        rcv = np.maximum(i - rng.integers(1, 40, N), -1)
        rcv[rng.random(N) < 0.03] = -1
        return rcv, 0
    if kind == "sink_heavy":
        rcv = np.where(rng.random(N) < 0.9, -1, rng.integers(0, N, N))
        rcv = np.where(rcv >= i, -1, rcv)      # no cycles
        return rcv, 0
    rcv = np.where(rng.random(N) < 0.45, 17, np.maximum(i - 5, -1))
    rcv[:18] = -1
    return rcv, 0


def values(seed: int, f: int = 0):
    """float32 [N] (or [N, f]) with zeros and -0.0 among them."""
    rng = np.random.default_rng(seed)
    shape = (N,) if f == 0 else (N, f)
    v = rng.standard_normal(shape).astype(np.float32)
    v[rng.random(shape) < 0.1] = 0.0
    v[rng.random(shape) < 0.1] = -0.0
    return v


def assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


# ── the loops this port ran before (per round: a sum and a gather) ─────

def loop_before(s, p, rounds: int, stop_at_sink: bool):
    """(s, rounds run) of the Python loops that ``accumulate_relax``
    replaced: flow counts and ``downstream_accumulate`` checked ``(p !=
    sink).any()`` before every round; the ice flow ran all its rounds."""
    n = s.shape[0]
    ran = 0
    for _ in range(rounds):
        if stop_at_sink and not bool((p != n).any()):
            break
        if s.dtype == torch.int32:
            s = s + torch.zeros(n + 1, dtype=torch.int32).index_add(
                0, p, s)[:n]
        else:
            s = s + sweep_cuda.ordered_sum_plain(n, p, s)
        p = torch.cat([p, p.new_tensor([n])])[p]
        ran += 1
    return s, ran


# ── against the JAX functions ──────────────────────────────────────────

@pytest.mark.parametrize("kind", KINDS)
def test_flow_accumulation_matches_jax(kind):
    from planet_heightmap_generation_tpu.erosion import fluvial as jfl
    from planet_heightmap_generation_torch.erosion import fluvial as tfl

    rcv, rounds = forest(kind)
    rng = np.random.default_rng(1)
    land = rng.random(N) < 0.9
    is_pit = rng.random(N) < 0.05
    want = jfl.flow_accumulation(jnp.asarray(land), jnp.asarray(
        rcv.astype(np.int32)), jnp.asarray(is_pit), rounds=rounds)
    got = tfl.flow_accumulation(torch.as_tensor(land), torch.as_tensor(rcv),
                                torch.as_tensor(is_pit), rounds=rounds)
    assert float(got.max()) >= 3     # some cell drains others
    assert_bits(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS + ["cycle"])
def test_monotonic_enforce_matches_jax(kind):
    """The flood carve's max-plus doubling ``elev'[r] = max_k(g[d^k(r)] +
    k·ε)`` against the JAX function, bit for bit. On drain pointers that
    lead into a cycle (the ``cycle`` forest: a 3-cycle fed by a chain) the
    doubling never reaches the sink and runs its whole round cap R =
    ceil(log2 N) + 2 in both packages, adding (2^R - 1)·ε to every cell
    leading into the cycle: a rise set by the mesh size, not the terrain
    (the growth of the elevation maximum with N, ROADMAP §3 item 6)."""
    from planet_heightmap_generation_tpu.erosion import flood as jfd
    from planet_heightmap_generation_torch.erosion import flood as tfd
    from planet_heightmap_generation_torch.erosion.fluvial import log_rounds

    rcv, rounds = forest("pits" if kind == "cycle" else kind)
    ring = [100, 101, 102]
    rng = np.random.default_rng(4)
    elev = rng.random(N).astype(np.float32)
    is_ocean = rng.random(N) < 0.1
    valid = rng.random(N) < 0.97
    if kind == "cycle":
        rcv[ring] = [101, 102, 100]
        rcv[103:110] = 102            # a few cells drain into the cycle
        is_ocean[ring], valid[ring] = False, True
    want = jfd.monotonic_enforce(jnp.asarray(elev), jnp.asarray(
        rcv.astype(np.int32)), jnp.asarray(is_ocean), jnp.asarray(valid),
        rounds=rounds)
    got = tfd.monotonic_enforce(torch.as_tensor(elev), torch.as_tensor(rcv),
                                torch.as_tensor(is_ocean),
                                torch.as_tensor(valid), rounds=rounds)
    assert_bits(got.numpy(), want)
    if kind == "cycle":
        rise = got.numpy()[ring] - elev[ring].max()
        np.testing.assert_allclose(rise, (2 ** log_rounds(N) - 1) * tfd.EPS,
                                   rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_downstream_accumulate_matches_jax(kind):
    from planet_heightmap_generation_tpu.erosion import flood as jfd
    from planet_heightmap_generation_torch.erosion import flood as tfd

    rcv, rounds = forest(kind)
    v = values(2)
    sink_mask = np.random.default_rng(3).random(N) < 0.1
    want = jfd.downstream_accumulate(
        jnp.asarray(v), jnp.asarray(rcv.astype(np.int32)),
        jnp.asarray(sink_mask), rounds=rounds)
    got = tfd.downstream_accumulate(torch.as_tensor(v), torch.as_tensor(rcv),
                                    torch.as_tensor(sink_mask), rounds=rounds)
    assert_bits(got.numpy(), want)


@jax.jit
def _jax_ice_flow(s, p):
    """The JAX glacial step's ice flow (erosion/glacial.py:69-79)."""
    n = s.shape[0]

    def step(carry, _):
        s, p = carry
        added = jnp.zeros(n + 1, s.dtype).at[p].add(s)
        s2 = s + added[:n]
        p2 = jnp.concatenate([p, np.array([n], p.dtype)])[p]
        return (s2, p2), None

    (s, _), _ = jax.lax.scan(step, (s, p), None, length=22)
    return s


def _ice_pointers(kind):
    rcv, _ = forest(kind)
    return np.where(rcv >= 0, rcv, N)


@pytest.mark.parametrize("kind", KINDS)
def test_ice_flow_loop_matches_jax(kind):
    from planet_heightmap_generation_torch.erosion.glacial import (
        ICE_FLOW_STEPS)

    p = _ice_pointers(kind)
    s = np.abs(values(4)) * (np.random.default_rng(5).random(N) < 0.7)
    s[::7] = -0.0
    want = _jax_ice_flow(jnp.asarray(s), jnp.asarray(p.astype(np.int32)))
    got, ran = sweep_cuda.accumulate_relax(
        torch.as_tensor(s), torch.as_tensor(p), ICE_FLOW_STEPS,
        stop_at_sink=False)
    assert_bits(got.numpy(), want)
    assert 1 <= int(ran) <= ICE_FLOW_STEPS
    assert torch.equal(got, pointer_accumulate(
        torch.as_tensor(s), torch.as_tensor(p), ICE_FLOW_STEPS,
        stop_at_sink=False))


def test_ice_flow_negative_zero_and_early_stop():
    """Where every pointer reaches the sink within a few rounds, the port
    stops there, and the 22-round scan gives the same bits: the first
    round turns each -0.0 into +0.0 (added starts at +0.0), after which
    adding +0.0 changes nothing. With no pointer off the sink at all the
    port still runs that one round."""
    s = np.zeros(N, np.float32)
    s[::2] = -0.0
    s[1::4] = 0.25
    p = np.full(N, N)
    p[1:200] = np.arange(0, 199)    # a 200-cell chain: 8 doublings
    for ptr, want_rounds in ((p, 8), (np.full(N, N), 1)):
        want = _jax_ice_flow(jnp.asarray(s), jnp.asarray(
            ptr.astype(np.int32)))
        got, ran = sweep_cuda.accumulate_relax(
            torch.as_tensor(s), torch.as_tensor(ptr), 22, stop_at_sink=False)
        assert int(ran) == want_rounds
        assert_bits(got.numpy(), want)
        assert not np.signbit(got.numpy()).any()


@pytest.mark.parametrize("f", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_ordered_index_sum_matches_jnp(kind, f):
    rcv, _ = forest(kind)
    idx = np.where(rcv >= 0, rcv, N)
    v = values(6, 0 if f == 1 else f)
    want = jnp.zeros((N + 1, *v.shape[1:]), jnp.float32).at[
        jnp.asarray(idx)].add(jnp.asarray(v))[:N]
    got = ordered_index_sum(N, torch.as_tensor(idx), torch.as_tensor(v))
    assert_bits(got.numpy(), want)


# ── the plain version against the loops it replaced ────────────────────

@pytest.mark.parametrize("case", ["float", "f3", "int"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_loop_equals_the_loops_it_replaced(kind, case):
    rcv, rounds = forest(kind)
    rounds = rounds or 14
    p = torch.as_tensor(np.where(rcv >= 0, rcv, N))
    s = {"float": torch.as_tensor(values(7)),
         "f3": torch.as_tensor(values(8, 3)),
         "int": torch.as_tensor(rcv >= 0).to(torch.int32)}[case]
    for stop in (True, False):
        got, ran = sweep_cuda.accumulate_relax_plain(s, p, rounds, stop)
        want, want_ran = loop_before(s, p, rounds, stop)
        assert got.dtype == s.dtype
        assert_bits(got.numpy(), want.numpy())
        if stop:
            assert int(ran) == want_ran
        else:
            # the loops it replaced ran every round; the plain version
            # stops once a round ran and no pointer is off the sink
            assert 1 <= int(ran) <= want_ran == rounds
        assert torch.equal(sweep_cuda.accumulate_relax(s, p, rounds, stop)[0],
                           got)
