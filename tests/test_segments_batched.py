"""Oracles for the batched transposed-layout segment primitives.

The meiosis merge (`segments.meiose`) is checked against the *functional*
definition of a gamete — at every position q the child carries the founder
hap of the parent chromatid that is active there (`recombine`,
`/root/reference/src/Simulation.cpp:2903-2958`) — rather than against one
particular boundary-list encoding, because the merge_ibd=True mode
deliberately keeps probe-equivalent duplicate boundaries (see the meiose
docstring). The .int-fidelity mode (merge_ibd=False) is additionally pinned
to the exact part-splitting encoding: unique positions, every crossover a
boundary.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from geneevolve_tpu.core import segments

BIG = segments._big()


def np_active(xo_row, start, q):
    """Reference chromatid-at-q: (start + #{xo <= q}) % 2."""
    xo = xo_row[xo_row < BIG]
    return (start + np.searchsorted(xo, q, side="right")) % 2


def np_hap_at(st_row, hap_row, q):
    st = st_row
    idx = np.searchsorted(st, q, side="right") - 1
    return hap_row[idx]


def random_ledger(rng, n, S, n_real_max, length=10_000_000):
    st = np.full((n, 2, S), BIG, dtype=np.int64)
    hap = np.zeros((n, 2, S), dtype=np.int32)
    for i in range(n):
        for c in range(2):
            k = rng.integers(1, n_real_max + 1)
            pos = np.sort(rng.choice(length, size=k, replace=False))
            pos[0] = 0  # ledger invariant: first boundary = chr start
            st[i, c, :k] = pos
            hap[i, c, :k] = rng.integers(0, 1000, size=k)
    return st, hap


@pytest.mark.parametrize("merge_ibd", [True, False])
def test_meiose_probe_oracle(merge_ibd):
    rng = np.random.default_rng(0)
    n, S, K = 64, 20, 7
    st, hap = random_ledger(rng, n, S, 12)
    xo = np.full((n, K), BIG, dtype=np.int64)
    for i in range(n):
        k = rng.integers(0, K)
        xo[i, :k] = np.sort(rng.choice(10_000_000, size=k, replace=False))
    sh = rng.integers(0, 2, size=n)

    c_st, c_hap, nv = segments.meiose(
        jnp.asarray(st, dtype=segments.pos_dtype()),
        jnp.asarray(hap),
        jnp.asarray(xo, dtype=segments.pos_dtype()),
        jnp.asarray(sh),
        S + K + 2,
        merge_ibd,
    )
    c_st = np.asarray(c_st)
    c_hap = np.asarray(c_hap)
    nv = np.asarray(nv)

    q = np.sort(rng.choice(10_000_000, size=200, replace=False))
    for i in range(n):
        # probe the child's ledger
        got = np_hap_at(c_st[i], c_hap[i], q)
        # expected: hap of the active parent chromatid at q
        act = np_active(xo[i], sh[i], q)
        want = np.where(
            act == 0,
            np_hap_at(st[i, 0], hap[i, 0], q),
            np_hap_at(st[i, 1], hap[i, 1], q),
        )
        np.testing.assert_array_equal(got, want, err_msg=f"child {i}")
        # ledger structure: starts at chr start, sorted, BIG-padded suffix
        assert c_st[i, 0] == 0
        valid = c_st[i][c_st[i] < BIG]
        assert len(valid) == nv[i]
        assert np.all(np.diff(valid) >= 0)
        assert np.all(c_st[i][len(valid):] >= BIG)
        if not merge_ibd:
            # exact part splitting: unique positions, every real crossover
            # inside the chromosome is a boundary
            assert len(np.unique(valid)) == len(valid)
            for x in xo[i][xo[i] < BIG]:
                assert x in valid


def test_meiose_no_duplicate_accumulation():
    """Repeated self-meiosis must not grow the ledger via chr-start or
    boundary duplicates (the merge_ibd=True mode keeps probe-equivalent
    duplicates only when a crossover lands exactly on a boundary)."""
    rng = np.random.default_rng(1)
    n, S = 16, 40
    st = np.full((n, 2, S), BIG, dtype=np.int64)
    hap = np.zeros((n, 2, S), dtype=np.int32)
    st[:, :, 0] = 0
    hap[:, 0, 0] = np.arange(n) * 2
    hap[:, 1, 0] = np.arange(n) * 2 + 1
    st_j = jnp.asarray(st, dtype=segments.pos_dtype())
    hap_j = jnp.asarray(hap)
    counts = []
    for g in range(8):
        r = np.random.default_rng(100 + g)
        xo = np.full((n, 4), BIG, dtype=np.int64)
        for i in range(n):
            k = r.integers(0, 3)
            xo[i, :k] = np.sort(r.choice(10_000_000, size=k, replace=False))
        sh = r.integers(0, 2, size=n)
        c_st, c_hap, nv = segments.meiose(
            st_j, hap_j, jnp.asarray(xo, dtype=segments.pos_dtype()),
            jnp.asarray(sh), S, True,
        )
        st_j = jnp.stack([c_st, c_st[::-1]], axis=1)
        hap_j = jnp.stack([c_hap, c_hap[::-1]], axis=1)
        counts.append(int(np.asarray(nv).max()))
    # ~2 crossovers per gen per chromatid pair: valid boundaries stay
    # near 1 + total crossovers, far below the duplicate-per-gen failure
    assert counts[-1] <= 1 + 8 * 4


def test_inherit_mutations_oracle():
    rng = np.random.default_rng(2)
    n, M, K, Mn, cap = 48, 6, 5, 4, 14
    mut = np.full((n, 2, M), BIG, dtype=np.int64)
    for i in range(n):
        for c in range(2):
            k = rng.integers(0, M + 1)
            mut[i, c, :k] = np.sort(
                rng.choice(1_000_000, size=k, replace=False)
            )
    xo = np.full((n, K), BIG, dtype=np.int64)
    for i in range(n):
        k = rng.integers(0, K)
        xo[i, :k] = np.sort(rng.choice(1_000_000, size=k, replace=False))
    sh = rng.integers(0, 2, size=n)
    new = np.full((n, Mn), BIG, dtype=np.int64)
    for i in range(n):
        k = rng.integers(0, Mn + 1)
        new[i, :k] = rng.choice(1_000_000, size=k, replace=False)

    got, nv = segments.inherit_mutations(
        jnp.asarray(mut, dtype=segments.pos_dtype()),
        jnp.asarray(xo, dtype=segments.pos_dtype()),
        jnp.asarray(sh),
        jnp.asarray(new, dtype=segments.pos_dtype()),
        cap,
    )
    got = np.asarray(got)
    for i in range(n):
        keep = set()
        for c in range(2):
            for p in mut[i, c][mut[i, c] < BIG]:
                if np_active(xo[i], sh[i], p) == c:
                    keep.add(int(p))
        keep |= set(int(p) for p in new[i][new[i] < BIG])
        want = np.sort(np.array(sorted(keep), dtype=np.int64))
        valid = got[i][got[i] < BIG]
        np.testing.assert_array_equal(valid, want, err_msg=f"row {i}")


def test_sample_point_process_law():
    key = jax.random.key(0)
    n, cap = 20_000, 16
    nbins = 40
    width = 1000
    bp = jnp.arange(nbins, dtype=segments.pos_dtype()) * width
    mass = np.full(nbins, 0.1, dtype=np.float32)
    mass[0] = 0.0
    cum = jnp.asarray(np.cumsum(mass))
    lam = float(mass.sum())
    pos = np.asarray(
        segments.sample_point_process(key, n, cap, cum, lam, bp, width, False)
    )
    counts = (pos < BIG).sum(axis=1)
    # Poisson(3.9) mean/var
    assert abs(counts.mean() - lam) < 0.05
    assert abs(counts.var() - lam) < 0.15
    # rows non-decreasing in bin index (within-bin offsets are independent
    # uniforms and may be unordered), padding contiguous at the end
    for i in range(0, n, 997):
        row = pos[i]
        v = row[row < BIG]
        assert np.all(np.diff(v // width) >= 0)
        assert np.all(row[len(v):] >= BIG)
    # positions uniform across bins 1..nbins-1 (bin 0 has zero mass)
    v = pos[pos < BIG]
    assert v.min() >= width  # nothing lands in the zero-mass first bin
    hist, _ = np.histogram(v // width, bins=np.arange(nbins + 1))
    expected = len(v) / (nbins - 1)
    assert np.all(np.abs(hist[1:] - expected) < 6 * np.sqrt(expected))


def test_cdf_grid_matches_searchsorted():
    """The inverse-CDF grid path must reproduce the searchsorted path
    bit-exactly for the same RNG key (same draws, same bin resolution)."""
    rng = np.random.default_rng(7)
    nbins = 300
    width = 50_000
    mass = rng.gamma(0.4, 1.0, size=nbins).astype(np.float32) * 0.01
    mass[0] = 0.0
    mass[rng.choice(nbins, 40, replace=False)] = 0.0  # zero-mass runs
    cum = jnp.asarray(np.cumsum(mass))
    bp = (jnp.arange(nbins) * width).astype(segments.pos_dtype())
    lam = float(mass.sum())
    table, W = segments.build_cdf_grid(np.cumsum(mass))
    n, cap = 5000, 12
    for inclusive in (False, True):
        for affine in (False, True):
            key = jax.random.key(11)
            ref = segments.sample_point_process(
                key, n, cap, cum, lam, bp, width, inclusive
            )
            got = segments.sample_point_process(
                key, n, cap, cum, lam, bp, width, inclusive,
                grid=jnp.asarray(table), grid_w=W,
                bp0=jnp.asarray(bp[0]) if affine else None,
                bp_step=(
                    jnp.asarray(width, segments.pos_dtype())
                    if affine
                    else None
                ),
            )
            np.testing.assert_array_equal(
                np.asarray(got), np.asarray(ref),
                err_msg=f"inclusive={inclusive} affine={affine}",
            )


def test_cdf_grid_flat_runs_exact():
    """Long runs of zero-mass bins (equal cum values) must not corrupt the
    grid: the raw (un-deduplicated) window span here is ~600 boundaries,
    far past W_MAX — the old clamped grid placed crossovers megabases
    inside zero-recombination gaps. Run-length dedup keeps W tiny and the
    result bit-exact vs searchsorted."""
    rng = np.random.default_rng(3)
    nbins = 2000
    width = 50_000
    mass = np.zeros(nbins, dtype=np.float32)
    # a handful of live bins separated by enormous dead runs
    live = np.array([1, 2, 600, 601, 1200, 1999])
    mass[live] = rng.gamma(1.0, 1.0, size=len(live)).astype(np.float32)
    cum = jnp.asarray(np.cumsum(mass))
    bp = (jnp.arange(nbins) * width).astype(segments.pos_dtype())
    lam = float(mass.sum())
    table, W = segments.build_cdf_grid(np.cumsum(mass))
    assert table is not None and W <= 13
    n, cap = 4000, 12
    key = jax.random.key(5)
    ref = segments.sample_point_process(
        key, n, cap, cum, lam, bp, width, False
    )
    got = segments.sample_point_process(
        key, n, cap, cum, lam, bp, width, False,
        grid=jnp.asarray(table), grid_w=W,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # every sampled point sits inside a live bin
    v = np.asarray(got)[np.asarray(got) < BIG]
    assert set(np.unique(v // width)).issubset(set(live.tolist()))


def _map_with_dead_runs(rng, nbins):
    """A 50 kb-bin recombination map shaped like the human b37 maps:
    gamma-distributed bin masses with megabase runs of zero-mass bins (a
    centromere-sized gap of 600 bins plus scattered shorter ones) — runs
    that inflate an undeduplicated grid cell's span far past W_MAX."""
    mass = rng.gamma(0.5, 1.0, size=nbins) * 0.0013 / 0.5
    mass[0] = 0.0
    mass[nbins // 3 : nbins // 3 + 600] = 0.0  # centromere
    for start in rng.choice(nbins - 300, 12, replace=False):
        mass[start : start + rng.integers(20, 300)] = 0.0
    return mass


def test_cdf_grid_real_recom_map():
    """Maps shaped like the real Recom.Map.b37 chromosomes — long flat cum
    runs of zero-mass bins — must build a usable grid thanks to run-length
    dedup, and match searchsorted bit-exactly; no sample may land inside a
    zero-mass bin."""
    rng = np.random.default_rng(21)
    width = 50_000
    for nbins in (4980, 4860):  # chr1- and chr2-sized maps
        prob = _map_with_dead_runs(rng, nbins)
        cum_np = np.cumsum(prob.astype(np.float32))
        runs = np.diff(np.flatnonzero(np.diff(cum_np) != 0))
        assert runs.max() > 250  # raw spans far beyond W_MAX
        table, W = segments.build_cdf_grid(cum_np)
        assert table is not None and 0 < W <= 13, f"W={W}"
        bp_np = np.arange(nbins, dtype=np.int64) * width
        bp = jnp.asarray(bp_np, segments.pos_dtype())
        cum = jnp.asarray(cum_np)
        lam = float(cum_np[-1])
        key = jax.random.key(13 + nbins)
        n, cap = 3000, 10
        ref = segments.sample_point_process(
            key, n, cap, cum, lam, bp, width, False
        )
        got = segments.sample_point_process(
            key, n, cap, cum, lam, bp, width, False,
            grid=jnp.asarray(table), grid_w=W,
        )
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(ref), err_msg=f"nbins={nbins}"
        )
        pos = np.asarray(got)
        v = pos[pos < BIG]
        bins = np.minimum(np.searchsorted(bp_np, v, side="right") - 1,
                          nbins - 1)
        assert np.all(prob[bins] > 0)


def _grid_cases():
    rng = np.random.default_rng(0)
    cases = {}
    # engine CDFs are padded to a common K with their final value
    cases["padded_tail"] = (
        np.concatenate([np.cumsum(np.ones(100, np.float32)),
                        np.full(28, 100.0, np.float32)]),
        np.array([0.0, 0.5, 1.0, 99.0, 99.5, 99.999], np.float32),
    )
    cases["single_bin"] = (np.array([2.5], np.float32),
                           np.array([0.0, 1.0, 2.4], np.float32))
    cum = np.cumsum(rng.exponential(size=300).astype(np.float32))
    cases["boundary_u"] = (cum, np.concatenate([[0.0], cum[:-1]]))
    for K in (7, 1000, 5120):
        mass = rng.exponential(size=K).astype(np.float32)
        mass[rng.random(K) < 0.3] = 0.0  # flat runs
        mass[0] = 1.0
        cum = np.cumsum(mass, dtype=np.float32)
        u = rng.uniform(0, float(cum[-1]), size=4096).astype(np.float32)
        cases[f"flat_runs_K{K}"] = (
            cum, np.concatenate([u, cum[:64][cum[:64] < cum[-1]]])
        )
    return cases


@pytest.mark.parametrize("case", sorted(_grid_cases()))
def test_cdf_grid_bins_match_searchsorted(case):
    """`cdf_grid_bins` (the samplers' XLA inverse-CDF) equals
    min(np.searchsorted(cum, u, 'right'), K-1) for u in [0, total)."""
    cum, u = _grid_cases()[case]
    table, W = segments.build_cdf_grid(cum)
    assert table is not None
    got = np.asarray(segments.cdf_grid_bins(
        jnp.asarray(u), jnp.asarray(cum), jnp.asarray(table), W
    ))
    want = np.minimum(np.searchsorted(cum, u, side="right"), len(cum) - 1)
    np.testing.assert_array_equal(got, want)


def test_sampler_grid_path_chunked_bit_identical():
    """Above 2^20 probes the grid path runs in lax.map chunks; the draws
    stay bit-identical to the searchsorted path."""
    rng = np.random.default_rng(5)
    nbins, width = 3000, 50_000
    prob = _map_with_dead_runs(rng, nbins)
    cum_np = np.cumsum(prob.astype(np.float32))
    table, W = segments.build_cdf_grid(cum_np)
    bp = (jnp.arange(nbins) * width).astype(segments.pos_dtype())
    cum = jnp.asarray(cum_np)
    n, cap = 90_000, 12  # 1.08M probes > 2^20
    key = jax.random.key(2)
    args = (key, n, cap, cum, float(cum_np[-1]), bp, width, True)
    ref = segments.sample_point_process(*args)
    got = segments.sample_point_process(
        *args, grid=jnp.asarray(table), grid_w=W
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_resident_cv_matches_gather_path(tmp_path, monkeypatch):
    """The resident CV matrix (single-pop fast path) must give bit-identical
    A/D components and summary to re-gathering from the ledger each
    generation (`_ad_all`)."""
    import sys

    sys.path.insert(0, "/root/repo/tools")
    from mkscenario import make_scenario

    from geneevolve_tpu.config import parse_args
    from geneevolve_tpu.core.engine import Simulation

    flags = make_scenario(
        str(tmp_path / "sc"), n0=120, pop_size=150, gens=4, nchr=3, ncv=12,
    )
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]

    outs = {}
    for mode in ("resident", "gather"):
        if mode == "gather":
            monkeypatch.setenv("GE_NO_RESIDENT_CV", "1")
        else:
            monkeypatch.delenv("GE_NO_RESIDENT_CV", raising=False)
        cfg = parse_args(
            argv + ["--seed", "77", "--prefix", str(tmp_path / mode)]
        )
        sim = Simulation(cfg, verbose=False)
        assert (sim.pops[0].smaps.xo_grid is not None)
        sim.init_generation0()
        assert (sim.pops[0].state.cv is not None) == (mode == "resident")
        for g in range(1, sim.tot_gen + 1):
            sim.step(g)
        outs[mode] = {
            "P": sim.pops[0].state.comp["P"].copy(),
            "A": sim.pops[0].state.comp["A"].copy(),
            "D": sim.pops[0].state.comp["D"].copy(),
            "traj": sim.pops[0].traj["var_A"].copy(),
        }
    for k in outs["resident"]:
        np.testing.assert_array_equal(outs["resident"][k], outs["gather"][k])


def test_hap_at_and_flip_mask_oracle():
    rng = np.random.default_rng(3)
    n, S, Q = 32, 15, 50
    st, hap = random_ledger(rng, n, S, 10)
    q = np.sort(rng.choice(10_000_000, size=Q, replace=False))
    got = np.asarray(
        segments.hap_at(
            jnp.asarray(st, dtype=segments.pos_dtype()),
            jnp.asarray(hap),
            jnp.asarray(q, dtype=segments.pos_dtype()),
        )
    )
    for i in range(n):
        for c in range(2):
            np.testing.assert_array_equal(
                got[i, c], np_hap_at(st[i, c], hap[i, c], q)
            )
    # flip mask: exact membership
    mut = np.full((n, 2, 6), BIG, dtype=np.int64)
    mut[0, 0, 0] = q[3]
    mut[5, 1, :2] = [q[7], q[7] + 1]
    mask = np.asarray(
        segments.mutation_flip_mask(
            jnp.asarray(mut, dtype=segments.pos_dtype()),
            jnp.asarray(q, dtype=segments.pos_dtype()),
        )
    )
    want = np.zeros((n, 2, Q), dtype=bool)
    want[0, 0, 3] = True
    want[5, 1, 7] = True
    np.testing.assert_array_equal(mask, want)
