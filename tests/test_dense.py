"""Dense-engine unit tests: meiosis phase algebra, mutation bounds, step
shapes and sharding invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geneevolve_tpu.dense.step import (
    DenseConfig,
    _apply_mutations,
    _meiose_xla,
    _phase_batch,
    _sample_gamete_plan,
    init_state,
    make_step,
    phenotype_additive,
)


def _cfg(**kw):
    base = dict(n=32, m=512, n_chr=4, morgans_per_chr=1.0, xo_cap=6, ncv=16)
    base.update(kw)
    return DenseConfig(**base)


def _numpy_phase(xo, start, m, n_chr):
    """Oracle: per locus, parity of (#crossovers at positions <= locus within
    its chromosome) + start chromatid of that chromosome."""
    n = xo.shape[0]
    chr_len = m // n_chr
    out = np.zeros((n, m), dtype=np.int8)
    for i in range(n):
        for l in range(m):
            c = l // chr_len
            k = np.sum((xo[i, c] <= l) & (xo[i, c] < m))
            out[i, l] = (start[i, c] + k) % 2
    return out


def test_phase_matches_oracle():
    cfg = _cfg(n=8, m=64, n_chr=2, xo_cap=4)
    xo, start, _ = _sample_gamete_plan(jax.random.key(3), cfg, cfg.n)
    got = np.asarray(_phase_batch(xo, start, cfg.m, cfg.n_chr))
    want = _numpy_phase(np.asarray(xo), np.asarray(start), cfg.m, cfg.n_chr)
    np.testing.assert_array_equal(got, want)


def test_gamete_plan_within_chromosome():
    cfg = _cfg(n=64)
    xo, start, _ = _sample_gamete_plan(jax.random.key(0), cfg, cfg.n)
    xo = np.asarray(xo)
    chr_len = cfg.chr_len
    for c in range(cfg.n_chr):
        vals = xo[:, c, :]
        real = vals[vals < cfg.m]
        assert np.all(real >= c * chr_len)
        assert np.all(real < (c + 1) * chr_len)
    assert set(np.unique(np.asarray(start))) <= {0, 1}


def test_meiose_copies_parent_rows():
    """With zero crossovers the gamete equals one parent chromatid plane."""
    cfg = _cfg(n=16, morgans_per_chr=0.0)
    state = init_state(jax.random.key(1), cfg)
    parent = jnp.arange(cfg.n, dtype=jnp.int32)
    xo = jnp.full((cfg.n, cfg.n_chr, cfg.xo_cap), cfg.m, dtype=jnp.int32)
    chr_starts = np.zeros((cfg.n, cfg.n_chr), dtype=np.int32)
    for which in (0, 1):
        start = jnp.asarray(chr_starts + which)
        got = _meiose_xla(state["hapA"], state["hapB"], parent, xo, start, cfg)
        want = state["hapA"] if which == 0 else state["hapB"]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_mutations_flip_at_most_cap():
    cfg = _cfg(mut_rate=1.5, mut_cap=4)
    g = jnp.zeros((cfg.n, cfg.m), dtype=jnp.uint8)
    out, _ = _apply_mutations(jax.random.key(7), g, cfg)
    flips = np.asarray(out).sum(axis=1)
    assert flips.max() <= cfg.mut_cap
    assert flips.sum() > 0  # rate 1.5 over 32 gametes: ~certain


def test_step_shapes_and_determinism():
    cfg = _cfg(selection=True, mut_rate=0.5)
    state = init_state(jax.random.key(0), cfg)
    step = jax.jit(make_step(cfg))
    out1 = step(state, jax.random.key(9))
    out2 = step(state, jax.random.key(9))
    assert out1["hapA"].shape == (cfg.n, cfg.m)
    assert out1["hapA"].dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(out1["hapA"]), np.asarray(out2["hapA"]))
    np.testing.assert_array_equal(np.asarray(out1["hapB"]), np.asarray(out2["hapB"]))
    # different key -> different children
    out3 = step(state, jax.random.key(10))
    assert not np.array_equal(np.asarray(out1["hapA"]), np.asarray(out3["hapA"]))


def test_phenotype_additive_centering():
    cfg = _cfg()
    state = init_state(jax.random.key(2), cfg)
    bv = phenotype_additive(
        state["hapA"], state["hapB"], state["cv_idx"], state["eff"]
    )
    assert bv.shape == (cfg.n,)
    # dosages are centered by 2p, so breeding values are mean-~0
    assert abs(float(jnp.mean(bv))) < 1e-3 * cfg.ncv


def test_sharded_step_matches_single_device():
    from geneevolve_tpu.parallel import make_mesh, make_sharded_step, shard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = _cfg(n=32, m=512, selection=True, mut_rate=0.5)
    state = init_state(jax.random.key(0), cfg)
    key = jax.random.key(4)
    single = jax.jit(make_step(cfg))(state, key)

    mesh = make_mesh(jax.devices()[:8])
    sharded_in = shard_state(init_state(jax.random.key(0), cfg), mesh)
    out = make_sharded_step(cfg, mesh)(sharded_in, key)
    for k2 in ("hapA", "hapB"):
        np.testing.assert_array_equal(
            np.asarray(single[k2]), np.asarray(out[k2])
        )


def test_clip_counter_counts_truncated_draws():
    """Cap-overflow honesty: silent truncation is counted, not hidden
    (VERDICT r2 weak item 4)."""
    # generous caps at defaults: zero clips
    cfg = _cfg(n=64, mut_rate=0.5, mut_cap=8)
    state = init_state(jax.random.key(0), cfg)
    assert int(state["clip"]) == 0
    step = make_step(cfg)
    state = step(state, jax.random.key(1))
    assert int(state["clip"]) == 0
    # starved caps: Poisson(4) truncated at 1 clips ~98% of draws
    tight = _cfg(n=64, morgans_per_chr=4.0, xo_cap=1, mut_rate=4.0, mut_cap=1)
    st2 = init_state(jax.random.key(0), tight)
    st2 = make_step(tight)(st2, jax.random.key(1))
    clips = int(st2["clip"])
    assert clips > 0
    # counter accumulates across generations
    st3 = make_step(tight)(st2, jax.random.key(2))
    assert int(st3["clip"]) > clips


def test_clip_counter_packed_matches_plan_law():
    from geneevolve_tpu.dense import packed as pk

    cfg = pk.PackedConfig(
        n=32, m=32 * 32, n_chr=2, morgans_per_chr=3.0, xo_cap=2,
        mut_rate=3.0, mut_cap=2, ncv=8,
    )
    state = pk.init_state(jax.random.key(5), cfg)
    state = pk.make_step(cfg)(state, jax.random.key(6))
    assert int(state["clip"]) > 0
