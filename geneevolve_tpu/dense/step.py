"""Dense-engine generation step.

One jitted function advances the whole population one generation:

  1. additive phenotype from CV columns (gather + (n, ncv) reduction)
  2. selection-weighted random mating (categorical over parents)
  3. per-(gamete, chromosome) Poisson crossover sampling
  4. meiosis: `childA[c, l] = father_planes[phase(l)][f_c, l]` with
     `phase(l) = (start_hap[chr(l)] + #crossovers <= l in chr) & 1`
     — two row gathers + a select.
  5. de novo mutation XOR at Poisson-sampled loci.

State layout: the two chromatids of each individual live in two separate
(n, m) uint8 planes `hapA` (paternally inherited) and `hapB` (maternally
inherited) rather than an interleaved (2n, m) array. Separate planes make
the phenotype dosage a plain `A + B` and shard identically over an
(ind, loci) mesh.

This materializes genotypes every generation, i.e. it is the reference's
output-path painting (`/root/reference/src/Simulation.cpp:1186-1230`) fused
into the evolution loop — the right trade when genotypes are consumed per
generation, and the benchmark's ind x loci x gens/s metric.

This byte engine is the oracle of the bit-packed engine (`dense/packed.py`),
which the CLI runs.

Loci live in index space: chromosome c covers `[c*chr_len, (c+1)*chr_len)`
columns; crossover positions are sampled per chromosome with intensity
`morgans[c]` uniformly over its columns (a uniform genetic map; scenario maps
can be honored by pre-warping column order, since meiosis only needs genetic
positions to be monotone in column index).
"""

from __future__ import annotations

from dataclasses import dataclass
import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class DenseConfig:
    n: int  # individuals per generation
    m: int  # loci
    n_chr: int = 1
    morgans_per_chr: float = 1.0
    xo_cap: int = 16  # per gamete per chromosome
    mut_rate: float = 0.0  # expected de novo mutations per gamete (genome)
    mut_cap: int = 8
    ncv: int = 128
    selection: bool = False  # weight parents by a logistic of phenotype

    @property
    def chr_len(self) -> int:
        return self.m // self.n_chr


def _random_plane(key, thresh, rows, m):
    """(rows, m) uint8 Bernoulli(thresh/256) plane, generated in row chunks
    under jit so peak memory stays ~1x the uint8 state."""
    n_chunks = min(16, rows)
    while rows % n_chunks:
        n_chunks -= 1
    chunk = rows // n_chunks

    @jax.jit
    def gen(key, thresh):
        def body(i, hap):
            bits = jax.random.bits(
                jax.random.fold_in(key, i), (chunk, m), dtype=jnp.uint8
            )
            return jax.lax.dynamic_update_slice(
                hap, (bits < thresh[None, :]).astype(jnp.uint8), (i * chunk, 0)
            )

        return jax.lax.fori_loop(
            0, n_chunks, body, jnp.zeros((rows, m), dtype=jnp.uint8)
        )

    return gen(key, thresh)


def init_state(key: jax.Array, cfg: DenseConfig, maf_min: float = 0.05):
    """Founder chromatid planes with loci-specific allele frequencies, plus
    CV columns/effects for the phenotype path."""
    k1, ka, kb, k3 = jax.random.split(key, 4)
    freqs = jax.random.uniform(k1, (cfg.m,), minval=maf_min, maxval=1 - maf_min)
    # threshold random bytes (not float32 uniforms)
    thresh = (freqs * 256.0).astype(jnp.uint8)
    hapA = _random_plane(ka, thresh, cfg.n, cfg.m)
    hapB = _random_plane(kb, thresh, cfg.n, cfg.m)
    cv_idx = jnp.linspace(0, cfg.m - 1, cfg.ncv).astype(jnp.int32)
    eff = jax.random.normal(k3, (cfg.ncv,), dtype=jnp.float32)
    return {
        "hapA": hapA,
        "hapB": hapB,
        "cv_idx": cv_idx,
        "eff": eff,
        "clip": jnp.zeros((), jnp.int32),
    }


def _phase_batch(
    xo: jax.Array,  # (n, n_chr, K) crossover columns (padded with m = dropped)
    start: jax.Array,  # (n, n_chr) starting chromatid per chromosome
    m: int,
    n_chr: int,
) -> jax.Array:
    """(n, m) int8 phase per locus.

    Scatter the crossovers into an indicator, cumsum within each chromosome
    (crossover counts reset at chromosome starts), add the per-chromosome
    start chromatid, take parity. Everything stays int8 so the peak footprint
    is ~2x the haplotype block — the batched-searchsorted formulation lowers
    to sort loops with (n, m) int32 temps and OOMs at scale."""
    n = xo.shape[0]
    xo = xo.reshape(n, -1)
    K = xo.shape[1]
    ind = jnp.zeros((n, m), dtype=jnp.int8)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, K))
    ind = ind.at[rows, xo].add(1, mode="drop")  # pad positions == m drop out
    chr_len = m // n_chr
    per_chr = ind.reshape(n, n_chr, chr_len)
    cnt = jnp.cumsum(per_chr, axis=2, dtype=jnp.int8)
    phase = (start[:, :, None].astype(jnp.int8) + cnt) % 2
    return phase.reshape(n, m)


def _sample_gamete_plan(key, cfg: DenseConfig, n: int, cdf=None):
    """Per-chromosome crossover columns (n, n_chr, K) — unsorted, pad = m —
    plus per-chr start chromatids (n, n_chr) and the count of Poisson draws
    truncated at the cap K. Parity counting never needs
    sorted positions.

    With `cdf` (an (m,) monotone array of cumulative Morgans at each
    column), crossover counts are Poisson in each chromosome's map mass and
    positions follow the map by inverse-CDF (`ras_sim_loc_rec` semantics,
    `Simulation.cpp:2973-2995`); without it the map is uniform with
    `morgans_per_chr` per chromosome."""
    k1, k2, k3 = jax.random.split(key, 3)
    K = cfg.xo_cap
    if cdf is None:
        raw = jax.random.poisson(k1, cfg.morgans_per_chr, (n, cfg.n_chr))
        counts = jnp.minimum(raw, K)  # (n, n_chr)
        u = jax.random.uniform(k2, (n, cfg.n_chr, K))
        offs = (u * cfg.chr_len).astype(jnp.int32)
        base = (jnp.arange(cfg.n_chr) * cfg.chr_len)[None, :, None]
        pos = base + offs
    else:
        L = cfg.chr_len
        hi = cdf[(jnp.arange(cfg.n_chr) + 1) * L - 1]
        lo = jnp.concatenate([jnp.zeros((1,), cdf.dtype), hi[:-1]])
        lam = hi - lo  # (n_chr,) Morgans per chromosome
        raw = jax.random.poisson(k1, lam[None, :], (n, cfg.n_chr))
        counts = jnp.minimum(raw, K)
        u = (
            lo[None, :, None]
            + jax.random.uniform(k2, (n, cfg.n_chr, K), dtype=cdf.dtype)
            * lam[None, :, None]
        )
        pos = jnp.searchsorted(cdf, u.reshape(n, -1)).reshape(
            n, cfg.n_chr, K
        ).astype(jnp.int32)
    xo = jnp.where(jnp.arange(K)[None, None, :] < counts[..., None], pos, cfg.m)
    start = jax.random.randint(k3, (n, cfg.n_chr), 0, 2)
    # cap-sizing honesty: count truncated Poisson draws instead of clipping
    # silently. At default K=16 and human-scale <= 3 Morgans/chr,
    # P(Poisson > K) < 3e-9 per gamete-chromosome (Chernoff), so this stays
    # 0 in any realistic run — observable, not assumed.
    clip = jnp.sum(raw > K, dtype=jnp.int32)
    return xo, start, clip


def _meiose_xla(hapA, hapB, parent, xo, start, cfg: DenseConfig):
    """(n_child, m) gametes: gather both parent planes, select by phase."""
    phase = _phase_batch(xo, start, cfg.m, cfg.n_chr)
    h0 = hapA[parent]  # (n_child, m)
    h1 = hapB[parent]
    return jnp.where(phase == 0, h0, h1)


def _apply_mutations(key, gametes, cfg: DenseConfig):
    """Returns (mutated gametes, count of Poisson draws clipped at mut_cap)."""
    if cfg.mut_rate <= 0:
        return gametes, jnp.zeros((), jnp.int32)
    n = gametes.shape[0]
    k1, k2 = jax.random.split(key)
    raw = jax.random.poisson(k1, cfg.mut_rate, (n,))
    counts = jnp.minimum(raw, cfg.mut_cap)
    pos = jax.random.randint(k2, (n, cfg.mut_cap), 0, cfg.m)
    valid = jnp.arange(cfg.mut_cap)[None, :] < counts[:, None]
    hit = jnp.zeros_like(gametes)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], pos.shape)
    # XOR semantics: a position drawn twice flips twice and cancels — this
    # matches the reference's per-occurrence flip at paint time
    # (`Simulation.cpp:1218-1222`) and the packed engine's XOR masks
    hit = hit.at[rows, pos].add(valid.astype(gametes.dtype)) & 1
    return gametes ^ hit, jnp.sum(raw > cfg.mut_cap, dtype=jnp.int32)


def phenotype_additive(hapA, hapB, cv_idx, eff):
    """Breeding values via the gen-recomputed-frequency alpha model
    (`Simulation.cpp:2647-2711`, additive-only)."""
    from geneevolve_tpu.dense.packed import centered_dot

    t = (hapA[:, cv_idx] + hapB[:, cv_idx]).astype(jnp.float32)  # (n, ncv)
    return centered_dot(t, eff)


def make_step(cfg: DenseConfig, xo_cdf=None):
    """Returns step(state, key) -> state, jittable and shardable.

    xo_cdf: optional (m,) cumulative-Morgans-per-column array for
    map-aware crossover placement (see `_sample_gamete_plan`)."""
    def step(state, key):
        hapA, hapB = state["hapA"], state["hapB"]
        n_par = hapA.shape[0]
        n = cfg.n
        k_mate, k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(key, 5)

        if cfg.selection:
            bv = phenotype_additive(hapA, hapB, state["cv_idx"], state["eff"])
            z = (bv - jnp.mean(bv)) / (jnp.std(bv) + 1e-9)
            logits = z  # logistic directional selection on the phenotype
            km1, km2 = jax.random.split(k_mate)
            fathers = jax.random.categorical(km1, logits, shape=(n,))
            mothers = jax.random.categorical(km2, logits, shape=(n,))
        else:
            km1, km2 = jax.random.split(k_mate)
            fathers = jax.random.randint(km1, (n,), 0, n_par)
            mothers = jax.random.randint(km2, (n,), 0, n_par)

        xo_p, st_p, clip_p = _sample_gamete_plan(k_pat, cfg, n, xo_cdf)
        xo_m, st_m, clip_m = _sample_gamete_plan(k_mat, cfg, n, xo_cdf)
        childA = _meiose_xla(hapA, hapB, fathers, xo_p, st_p, cfg)
        childB = _meiose_xla(hapA, hapB, mothers, xo_m, st_m, cfg)
        childA, clip_a = _apply_mutations(k_mu1, childA, cfg)
        childB, clip_b = _apply_mutations(k_mu2, childB, cfg)
        return {
            "hapA": childA,
            "hapB": childB,
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            "clip": state.get("clip", 0) + clip_p + clip_m + clip_a + clip_b,
        }

    return step
