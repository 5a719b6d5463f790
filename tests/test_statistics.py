"""Statistical validation against population-genetics theory — the checks the
reference authors used (GeneEvolveDocumentation.pdf §3.2-3.5): heterozygosity
decay under drift, allele-frequency conservation in expectation, assortative
mating raising couple correlation, and directional selection shifting the
phenotype. Run on the dense engine (fast, pure device)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geneevolve_tpu.dense.step import DenseConfig, init_state, make_step


def _evolve(cfg, state, key, gens):
    step = jax.jit(make_step(cfg))
    for g in range(gens):
        state = step(state, jax.random.fold_in(key, g))
    return state


def _het(state):
    """Mean expected heterozygosity 2p(1-p) over loci."""
    t = (state["hapA"].astype(np.float32) + state["hapB"].astype(np.float32))
    p = np.asarray(jnp.mean(t, axis=0) / 2.0)
    return float(np.mean(2 * p * (1 - p)))


def test_heterozygosity_decay_under_drift():
    """h(t) = (1 - 1/2N)^t h(0) under pure drift (PDF Table 3.2)."""
    cfg = DenseConfig(n=50, m=4096, n_chr=4, morgans_per_chr=1.0, xo_cap=8)
    gens = 30
    reps = []
    for r in range(4):
        state = init_state(jax.random.key(r), cfg)
        h0 = _het(state)
        out = _evolve(cfg, state, jax.random.key(100 + r), gens)
        reps.append(_het(out) / h0)
    got = float(np.mean(reps))
    want = (1 - 1 / (2 * cfg.n)) ** gens
    assert abs(got - want) < 0.06, (got, want)


def test_allele_frequency_unbiased():
    """Drift is unbiased: E[p_t] = p_0 (PDF §3.2). With many loci the mean
    frequency shift is ~0."""
    cfg = DenseConfig(n=200, m=8192, n_chr=4)
    state = init_state(jax.random.key(1), cfg)
    p0 = np.asarray(
        jnp.mean(
            state["hapA"].astype(jnp.float32) + state["hapB"].astype(jnp.float32),
            axis=0,
        )
        / 2
    )
    out = _evolve(cfg, state, jax.random.key(2), 10)
    p1 = np.asarray(
        jnp.mean(
            out["hapA"].astype(jnp.float32) + out["hapB"].astype(jnp.float32),
            axis=0,
        )
        / 2
    )
    assert abs(float(np.mean(p1 - p0))) < 0.01


def test_directional_selection_shifts_phenotype():
    """Logistic selection on the phenotype raises the mean breeding value."""
    from geneevolve_tpu.dense.step import phenotype_additive

    cfg = DenseConfig(n=256, m=4096, n_chr=4, ncv=64, selection=True)
    state = init_state(jax.random.key(3), cfg)

    def raw_dosage_value(s):
        # un-centered genetic value: selection response shows up in the mean
        t = (s["hapA"][:, s["cv_idx"]] + s["hapB"][:, s["cv_idx"]]).astype(
            jnp.float32
        )
        return float(jnp.mean(t @ s["eff"]))

    v0 = raw_dosage_value(state)
    out = _evolve(cfg, state, jax.random.key(4), 8)
    v1 = raw_dosage_value(out)
    assert v1 > v0 + 0.5, (v0, v1)


def test_neutral_run_no_phenotype_shift():
    cfg = DenseConfig(n=256, m=4096, n_chr=4, ncv=64, selection=False)
    state = init_state(jax.random.key(3), cfg)
    t0 = (state["hapA"][:, state["cv_idx"]] + state["hapB"][:, state["cv_idx"]]).astype(jnp.float32)
    v0 = float(jnp.mean(t0 @ state["eff"]))
    out = _evolve(cfg, state, jax.random.key(4), 8)
    t1 = (out["hapA"][:, out["cv_idx"]] + out["hapB"][:, out["cv_idx"]]).astype(jnp.float32)
    v1 = float(jnp.mean(t1 @ out["eff"]))
    # drift-only: movement stays within a few SE of zero
    assert abs(v1 - v0) < 2.0, (v0, v1)


def _mosaic_founders(key, cfg, n_anc=16, switches_per_chr=4.0):
    """Founder planes with realistic LD: each founder chromatid is a mosaic
    of a small ancestral haplotype pool (switch points ~ Poisson per
    chromosome), the standard way a real phased panel carries LD blocks."""
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    freqs = rng.uniform(0.1, 0.9, size=cfg.m)
    anc = (rng.random((n_anc, cfg.m)) < freqs).astype(np.uint8)
    chr_len = cfg.chr_len
    planes = []
    for _ in range(2):
        plane = np.empty((cfg.n, cfg.m), dtype=np.uint8)
        for i in range(cfg.n):
            for c in range(cfg.n_chr):
                k = rng.poisson(switches_per_chr)
                cuts = np.sort(rng.integers(0, chr_len, size=k))
                bounds = np.concatenate([[0], cuts, [chr_len]])
                for b in range(len(bounds) - 1):
                    a = rng.integers(n_anc)
                    s, e = bounds[b] + c * chr_len, bounds[b + 1] + c * chr_len
                    plane[i, s:e] = anc[a, s:e]
        planes.append(jnp.asarray(plane))
    return planes[0], planes[1]


def _adjacent_r2(hapA, hapB, n_chr):
    """r^2 between adjacent intra-chromosome columns over all 2n haplotypes,
    plus a keep mask for pairs polymorphic enough to estimate (MAF > 0.05)."""
    h = np.concatenate(
        [np.asarray(hapA, dtype=np.float64), np.asarray(hapB, dtype=np.float64)]
    )
    m = h.shape[1]
    chr_len = m // n_chr
    p = h.mean(axis=0)
    cov = (h[:, :-1] * h[:, 1:]).mean(axis=0) - p[:-1] * p[1:]
    var = p * (1 - p)
    denom = var[:-1] * var[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(denom > 0, cov * cov / denom, 0.0)
    intra = (np.arange(m - 1) % chr_len) != chr_len - 1  # drop cross-chr pairs
    maf_ok = (np.minimum(p, 1 - p)[:-1] > 0.05) & (np.minimum(p, 1 - p)[1:] > 0.05)
    return r2, intra & maf_ok


def test_ld_preservation_over_generations():
    """LD (r^2) between tightly linked loci is preserved through 30
    generations of mating+recombination (PDF Table 3.3: corr between gen-0
    and gen-30 adjacent-pair r^2 ~= 0.994 at panel scale; drift at 2N=4096
    loosens that, hence the 0.85 floor)."""
    cfg = DenseConfig(n=2048, m=2048, n_chr=2, morgans_per_chr=1.0, xo_cap=8)
    hapA, hapB = _mosaic_founders(jax.random.key(7), cfg)
    state = {
        "hapA": hapA,
        "hapB": hapB,
        "cv_idx": jnp.linspace(0, cfg.m - 1, cfg.ncv).astype(jnp.int32),
        "eff": jnp.zeros((cfg.ncv,), jnp.float32),
    }
    r2_0, keep0 = _adjacent_r2(state["hapA"], state["hapB"], cfg.n_chr)
    out = _evolve(cfg, state, jax.random.key(8), 30)
    r2_t, keep_t = _adjacent_r2(out["hapA"], out["hapB"], cfg.n_chr)
    keep = keep0 & keep_t
    assert keep.sum() > 500  # enough informative pairs
    corr = float(np.corrcoef(r2_0[keep], r2_t[keep])[0, 1])
    assert corr > 0.85, corr
    # and no systematic collapse of LD level between tightly linked loci
    ratio = float(np.mean(r2_t[keep]) / np.mean(r2_0[keep]))
    assert 0.7 < ratio < 1.4, ratio


def test_var_a_growth_under_assortative_mating(tmp_path):
    """Assortative mating builds positive gametic-phase disequilibrium and
    inflates var(A) toward ~VA0/(1 - rho_A/2) with rho_A = r * h^2 (Fisher
    1918; PDF section 3.5 / Table 3.4 validates GeneEvolve the same way).
    With r=0.8 and h^2=0.8 the equilibrium ratio is ~1.47; random mating
    must stay flat. Runs the full-semantics engine."""
    from geneevolve_tpu.config import parse_args
    from geneevolve_tpu.core.engine import Simulation

    root = tmp_path / "am"
    root.mkdir()
    rng = np.random.default_rng(11)
    n0, nsnp, ncv_chr, chrs, gens, pop = 300, 120, 40, [1, 2], 8, 600
    cv_rows = []
    for c in chrs:
        hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
        np.savetxt(root / f"ref.chr{c}.hap", hap, fmt="%d")
        pos = np.sort(rng.choice(np.arange(1_000_000, 50_000_000), nsnp, False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            for i, p in enumerate(pos):
                f.write(f"rs{c}_{i} {p} A G\n")
        with open(root / f"ref.chr{c}.indv", "w") as f:
            f.writelines(f"{i + 1}\n" for i in range(n0))
        cv_cols = np.sort(rng.choice(nsnp, ncv_chr, replace=False))
        np.savetxt(root / f"cv.chr{c}.hap", hap[cv_cols], fmt="%d")
        for i in cv_cols:
            cv_rows.append((c, pos[i], rng.normal(), 0.0))
    with open(root / "cv.info", "w") as f:
        f.write("chr pos a d\n")
        for c, p, a, d in cv_rows:
            f.write(f"{c} {p} {a} {d}\n")
    with open(root / "hap_address.txt", "w") as f:
        f.write("chr hap legend sample\n")
        for c in chrs:
            f.write(f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                    f"{root}/ref.chr{c}.indv\n")
    with open(root / "cv_address.txt", "w") as f:
        for c in chrs:
            f.write(f"{c} {root}/cv.chr{c}.hap\n")
    with open(root / "rmap.txt", "w") as f:
        f.write("chr bp cM\n")
        for c in chrs:
            for bp in range(0, 60_000_000, 500_000):
                f.write(f"{c} {bp} {bp / 1_000_000:.6f}\n")

    def run(mat_cor, outdir):
        outdir.mkdir()
        with open(root / f"popinfo_{mat_cor}.txt", "w") as f:
            f.write("pop_size mat_cor offspring_dist selection_func "
                    "selection_func_par1 selection_func_par2\n")
            for _ in range(gens):
                f.write(f"{pop} {mat_cor} p thr 1 1\n")
        cfg = parse_args([
            "--file_gen_info", str(root / f"popinfo_{mat_cor}.txt"),
            "--file_hap_name", str(root / "hap_address.txt"),
            "--file_recom_map", str(root / "rmap.txt"),
            "--file_cv_info", str(root / "cv.info"),
            "--file_cvs", str(root / "cv_address.txt"),
            "--va", "1.0", "--ve", "0.25",
            "--seed", "2024",
            "--prefix", str(outdir / "out"),
        ])
        sim = Simulation(cfg, verbose=False)
        sim.run()
        lines = (outdir / "out.pop1.summary").read_text().splitlines()
        hdr = lines[0].split()
        col = hdr.index("ph1_var_A")
        return np.array([float(l.split()[col]) for l in lines[1:]])

    va_am = run(0.8, tmp_path / "am_run")
    va_rm = run(0.0, tmp_path / "rm_run")
    ratio_am = float(np.mean(va_am[-3:]) / va_am[0])
    ratio_rm = float(np.mean(va_rm[-3:]) / va_rm[0])
    assert ratio_am > 1.15, (ratio_am, va_am)
    assert 0.75 < ratio_rm < 1.25, (ratio_rm, va_rm)
    assert ratio_am > ratio_rm + 0.1, (ratio_am, ratio_rm)


def test_deme_migration_matches_panmictic_heterozygosity():
    """Deme mode is a *usable approximation* of the panmictic law only with
    migration: with ring migration at N_deme*m >> 1 the metapopulation's
    heterozygosity decays at the panmictic rate (1 - 1/2N)^t (Wright's
    island model, F_ST ~= 1/(1+4Nm) small); with mig_rate=0 each deme
    drifts at its own Ne = N/D, decaying D times faster. Mirrors the
    reference's migration semantics (`ras_do_migration`,
    Simulation.cpp:877-989) on the ppermute path."""
    from geneevolve_tpu.dense import packed as pk
    from geneevolve_tpu.parallel import mesh as pmesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")
    mesh = pmesh.make_mesh(jax.devices()[:8], shape=(8, 1))
    cfg = pk.PackedConfig(n=256, m=4096, n_chr=4, morgans_per_chr=1.0,
                          xo_cap=8)
    gens, reps = 40, 2
    D = 8

    def het(state):
        """Within-deme expected heterozygosity H_S averaged over demes
        (rows are block-sharded in deme order). H_S is the discriminating
        statistic: under isolation the *total* H_T stays high while demes
        fix (Wright's H_S vs H_T), so pooled frequencies would not detect
        the missing migration."""
        a = np.asarray(pk.unpack_bits(state["hap"][:, 0], cfg.m), np.float64)
        b = np.asarray(pk.unpack_bits(state["hap"][:, 1], cfg.m), np.float64)
        h = np.concatenate([a, b])  # (2n, m), deme d = rows d*nd:(d+1)*nd
        nd = cfg.n // D
        hs = []
        for d in range(D):
            rows = np.r_[d * nd : (d + 1) * nd,
                         cfg.n + d * nd : cfg.n + (d + 1) * nd]
            p = h[rows].mean(axis=0)
            hs.append(np.mean(2 * p * (1 - p)))
        return float(np.mean(hs))

    def run(mig_rate, rep):
        state = pk.init_state(jax.random.key(20 + rep), cfg)
        state = pmesh.shard_state(state, mesh)
        step = pmesh.make_deme_step(cfg, mesh, mig_rate=mig_rate)
        h0 = het(state)
        key = jax.random.key(50 + rep)
        for g in range(gens):
            state = step(state, jax.random.fold_in(key, g))
        return het(state) / h0

    ratio_mig = float(np.mean([run(0.125, r) for r in range(reps)]))
    ratio_iso = float(np.mean([run(0.0, r) for r in range(reps)]))
    want_pan = (1 - 1 / (2 * cfg.n)) ** gens  # ~0.925
    want_iso = (1 - 1 / (2 * cfg.n / D)) ** gens  # ~0.534
    assert abs(ratio_mig - want_pan) < 0.06, (ratio_mig, want_pan)
    assert abs(ratio_iso - want_iso) < 0.10, (ratio_iso, want_iso)
    assert ratio_mig > ratio_iso + 0.2


def test_assortative_mating_couple_correlation():
    """Rank-matching through an MVN(r) template yields couple mating-value
    correlation ~= r (reference `assort_mate`, Simulation.cpp:2257-2301)."""
    from geneevolve_tpu.core.mating import assort_mate

    rng = np.random.default_rng(5)
    n = 4000
    mv = rng.normal(size=n)
    sex = rng.integers(1, 3, size=n)
    ped = {k: np.arange(n) for k in ("father", "ff", "fm", "mf", "mm")}
    for r_target in (0.0, 0.5, 0.9):
        plan = assort_mate(
            np.random.default_rng(6), mv, np.ones(n), sex, ped,
            r_target, 0.0, False, "p", n,
        )
        got = plan.couple_cor_mating_value(mv)
        assert abs(got - r_target) < 0.08, (r_target, got)
