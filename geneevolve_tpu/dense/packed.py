"""Bit-packed dense engine: 32 loci per uint32 word.

Meiosis, mutation, and chromatid selection are all bitwise, so the haplotype
planes pack losslessly into one `(n, 2, mw)` uint32 array with `mw = m / 32`
(locus l lives in word `l >> 5`, bit `l & 31`, LSB-first; plane 0/1 =
chromatid A/B). Every HBM pass shrinks 32x against the byte engine
(`dense/step.py`) per element — 8x in bytes — and the combined plane layout
keeps a parent's two chromatids in one contiguous row.

The crossover phase is a *word mask*: parity-of-count is XOR of
per-crossover indicators, and the indicator of "locus >= xo" restricted to
one chromosome is, per word w (global column space),

    mask_k[w] = ~0                  if w >  xo >> 5
              = ~0 << (xo & 31)     if w == xo >> 5     (boundary word)
              = 0                   otherwise

so `phase = (start ? ~0 : 0) ^ XOR_k mask_k` and the gamete is the
arithmetic select `A ^ (phase & (A ^ B))`. De novo mutations XOR single-bit
words the same way. Reference semantics: `recombine` + `ras_sim_loc_rec` +
`ras_add_mutation` (`/root/reference/src/Simulation.cpp:2903-2995,
2497-2552`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from geneevolve_tpu.dense.step import DenseConfig, _sample_gamete_plan

FULL = np.uint32(0xFFFFFFFF)


def pack_bits(bits: jax.Array) -> jax.Array:
    """(..., m) 0/1 -> (..., m/32) uint32, LSB-first."""
    m = bits.shape[-1]
    assert m % 32 == 0
    b = bits.reshape(*bits.shape[:-1], m // 32, 32).astype(jnp.uint32)
    w = jnp.left_shift(b, jnp.arange(32, dtype=jnp.uint32))
    # bits occupy distinct positions, so sum == bitwise or
    return w.sum(axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jax.Array, m: int) -> jax.Array:
    """(..., mw) uint32 -> (..., m) 0/1 uint8."""
    w = jnp.right_shift(
        packed[..., None], jnp.arange(32, dtype=jnp.uint32)
    ) & jnp.uint32(1)
    return w.reshape(*packed.shape[:-1], packed.shape[-1] * 32)[
        ..., :m
    ].astype(jnp.uint8)


@dataclass(frozen=True)
class PackedConfig:
    n: int
    m: int  # loci; must be divisible by 32*n_chr
    n_chr: int = 1
    morgans_per_chr: float = 1.0
    xo_cap: int = 16
    mut_rate: float = 0.0
    mut_cap: int = 8
    ncv: int = 128
    selection: bool = False
    couples: bool = False  # couple-structured mating: n//2 couples,
    # multinomial children SORTED by couple (the reference's household law,
    # `Simulation.cpp:2329-2355`)

    @property
    def chr_len(self) -> int:
        return self.m // self.n_chr

    @property
    def mw(self) -> int:
        return self.m // 32

    def as_dense(self) -> DenseConfig:
        return DenseConfig(
            n=self.n,
            m=self.m,
            n_chr=self.n_chr,
            morgans_per_chr=self.morgans_per_chr,
            xo_cap=self.xo_cap,
            mut_rate=self.mut_rate,
            mut_cap=self.mut_cap,
            ncv=self.ncv,
            selection=self.selection,
        )


def init_state(key: jax.Array, cfg: PackedConfig, maf_min: float = 0.05):
    """Packed founder planes + CV columns/effects."""
    from geneevolve_tpu.dense.step import init_state as dense_init

    assert cfg.m % 32 == 0 and cfg.chr_len % 32 == 0
    st = dense_init(key, cfg.as_dense(), maf_min)
    hap = jnp.stack([pack_bits(st["hapA"]), pack_bits(st["hapB"])], axis=1)
    return {
        "hap": hap,
        "cv": cv_from_planes(hap, st["cv_idx"]),
        "cv_idx": st["cv_idx"],
        "eff": st["eff"],
        "clip": jnp.zeros((), jnp.int32),
    }


def cv_from_planes(hap: jax.Array, cv_idx: jax.Array) -> jax.Array:
    """(n, 2, ncv) uint8 CV alleles extracted from the packed planes — used
    once at init; the step maintains this matrix incrementally."""
    return jnp.stack(
        [popcount_dosage(hap[:, 0], cv_idx), popcount_dosage(hap[:, 1], cv_idx)],
        axis=1,
    )


def init_state_streamed(
    key: jax.Array, cfg: PackedConfig, maf_min: float = 0.05,
    chunk_loci: int = 1 << 15,
):
    """Packed founder planes built chunk-by-chunk over loci, so the peak
    footprint is one (n, chunk) byte buffer + the 4 GiB-scale packed output —
    never the (n, m) unpacked array (`init_state` wraps the byte engine's
    init and OOMs at n*m > HBM). Same per-locus allele-frequency law as
    `dense/step.py:init_state` (uniform MAF, thresholded random bytes), but
    a different bit-stream."""
    while cfg.m % chunk_loci or chunk_loci % 32:
        chunk_loci //= 2
        if chunk_loci < 32:
            raise ValueError("m must be a multiple of 32")
    nchunks = cfg.m // chunk_loci
    kf, ka, kb, k3 = jax.random.split(key, 4)
    freqs = jax.random.uniform(
        kf, (cfg.m,), minval=maf_min, maxval=1 - maf_min
    )
    thresh = (freqs * 256.0).astype(jnp.uint8).reshape(nchunks, chunk_loci)

    @jax.jit
    def build(kplane):
        def one(carry, xs):
            i, th = xs
            kc = jax.random.fold_in(kplane, i)
            b = jax.random.bits(kc, (cfg.n, chunk_loci), dtype=jnp.uint8)
            return carry, pack_bits((b < th[None, :]).astype(jnp.uint8))

        _, words = jax.lax.scan(
            one, 0, (jnp.arange(nchunks), thresh)
        )  # (nchunks, n, chunk/32)
        return jnp.moveaxis(words, 0, 1).reshape(cfg.n, cfg.mw)

    cv_idx = jnp.linspace(0, cfg.m - 1, cfg.ncv).astype(jnp.int32)
    eff = jax.random.normal(k3, (cfg.ncv,), dtype=jnp.float32)
    hap = jnp.stack([build(ka), build(kb)], axis=1)
    return {
        "hap": hap,
        "cv": cv_from_planes(hap, cv_idx),
        "cv_idx": cv_idx,
        "eff": eff,
        "clip": jnp.zeros((), jnp.int32),
    }


def phase_word_masks(
    xo: jax.Array,  # (n, n_chr, K) crossover loci columns, pad = m
    start: jax.Array,  # (n, n_chr)
    cfg: PackedConfig,
) -> jax.Array:
    """(n, mw) uint32 phase mask per gamete: bit set -> take chromatid B."""
    n, n_chr, K = xo.shape
    cw = cfg.chr_len // 32
    # word columns local to a chromosome: (1, 1, cw)
    cols = jnp.arange(cw, dtype=jnp.int32)[None, None, :]
    chr_base = (jnp.arange(n_chr, dtype=jnp.int32) * cfg.chr_len)[
        None, :, None
    ]
    mask = jnp.where((start[:, :, None] & 1) == 1, FULL, jnp.uint32(0))
    mask = jnp.broadcast_to(mask, (n, n_chr, cw))
    for k in range(K):
        x = xo[:, :, k : k + 1] - chr_base  # local locus offset; pad -> huge
        xw = x >> 5
        partial = jnp.left_shift(FULL, (x & 31).astype(jnp.uint32))
        term = jnp.where(cols > xw, FULL, jnp.uint32(0)) | jnp.where(
            cols == xw, partial, jnp.uint32(0)
        )
        mask = mask ^ term
    return mask.reshape(n, cfg.mw)


def apply_mutations_packed(child: jax.Array, pos: jax.Array) -> jax.Array:
    """XOR single-bit flips at loci `pos` ((n, Km) int32, pad = m) into
    packed rows (n, mw), as a full-plane XOR-mask pass. Repeated draws flip
    twice and cancel (per-occurrence semantics, `Simulation.cpp:1218-1222`).

    The mask construction fuses into one streaming pass with no scatter."""
    n, mw = child.shape
    cols = jnp.arange(mw, dtype=jnp.int32)[None, None, :]
    p = pos[:, :, None]
    bit = jnp.left_shift(jnp.uint32(1), (p & 31).astype(jnp.uint32))
    # one XOR-reduction over the draws, so the (n, Km, mw) selects fuse
    # into a single pass instead of Km materialized (n, mw) masks
    hit = jax.lax.reduce(
        jnp.where(cols == (p >> 5), bit, jnp.uint32(0)),
        np.uint32(0), jax.lax.bitwise_xor, (1,),
    )
    return child ^ hit


def meiose_packed_xla(hap, parent, xo, start, cfg: PackedConfig):
    """(n_child, mw) packed gametes from parent planes (N, 2, mw)."""
    mask = phase_word_masks(xo, start, cfg)
    a = hap[parent, 0]
    b = hap[parent, 1]
    return a ^ (mask & (a ^ b))


def mutation_positions(key, n: int, cfg: PackedConfig):
    """(n, mut_cap) int32 de novo mutation loci, pad = m (past the last
    word), plus the count of Poisson draws truncated at mut_cap. Same key
    schedule as the byte engine's `_apply_mutations` (`dense/step.py`), so
    both engines flip identical loci."""
    k1, k2 = jax.random.split(key)
    raw = jax.random.poisson(k1, cfg.mut_rate, (n,))
    counts = jnp.minimum(raw, cfg.mut_cap)
    pos = jax.random.randint(k2, (n, cfg.mut_cap), 0, cfg.m)
    valid = jnp.arange(cfg.mut_cap)[None, :] < counts[:, None]
    clip = jnp.sum(raw > cfg.mut_cap, dtype=jnp.int32)
    return jnp.where(valid, pos, cfg.m).astype(jnp.int32), clip


def popcount_dosage(packed: jax.Array, idx: jax.Array) -> jax.Array:
    """Extract 0/1 alleles at loci `idx` from packed word rows (..., mw).

    NOTE: this is a scattered single-word column gather, latency- not
    bandwidth-bound. The evolution loop therefore does NOT use it per
    generation: it maintains the small
    dense CV matrix incrementally (`cv_child`, mirroring the reference's
    own design of keeping CV genotypes resident, `Simulation.cpp:2624-2749`
    / SURVEY §3.4) and uses this only at init and as a test oracle."""
    word = packed[..., idx >> 5]
    return (
        (word >> (idx & 31).astype(jnp.uint32)) & jnp.uint32(1)
    ).astype(jnp.uint8)


def cv_child(
    cv_par: jax.Array,  # (N, 2, ncv) uint8 parent CV alleles
    parent: jax.Array,  # (n,) parent rows for this gamete
    xo: jax.Array,  # (n, n_chr, K) crossover loci (global columns, pad = m)
    start: jax.Array,  # (n, n_chr) start chromatid
    mu,  # (n, Km) de novo mutation loci for this gamete (pad = m) | None
    cv_idx: jax.Array,  # (ncv,) int32 global CV columns
    chr_len: int,
) -> jax.Array:
    """(n, ncv) uint8 gamete CV alleles — the same meiosis law as the packed
    word masks (`phase_word_masks`: phase(l) = (start + #{xo <= l}) & 1,
    mutations flip per occurrence), restricted to the CV columns. O(n*ncv*K)
    vector work on bytes; no genome-plane traffic."""
    c_of = (cv_idx // chr_len).astype(jnp.int32)  # (ncv,) chromosome of CV
    # crossovers of the CV's own chromosome, counted at or below the CV locus
    xo_cv = jnp.take_along_axis(
        xo, c_of[None, :, None], axis=1
    )  # (n, ncv, K)
    cnt = jnp.sum(xo_cv <= cv_idx[None, :, None], axis=-1)  # (n, ncv)
    st_cv = jnp.take_along_axis(start, c_of[None, :], axis=1)  # (n, ncv)
    phase = ((st_cv + cnt) & 1).astype(jnp.uint8)
    a = cv_par[parent, 0]  # (n, ncv)
    b = cv_par[parent, 1]
    child = jnp.where(phase == 0, a, b)
    if mu is not None:
        flips = (
            jnp.sum(mu[:, :, None] == cv_idx[None, None, :], axis=1) & 1
        ).astype(jnp.uint8)
        child = child ^ flips
    return child


def phenotype_additive_packed(hap, cv_idx, eff):
    """Oracle path: breeding values via a plane column gather (slow per
    generation; see `popcount_dosage` note). The step uses
    `phenotype_from_cv` on the resident CV matrix instead."""
    t = (
        popcount_dosage(hap[:, 0], cv_idx) + popcount_dosage(hap[:, 1], cv_idx)
    ).astype(jnp.float32)
    return centered_dot(t, eff)


def centered_dot(t, eff):
    """(t - 2p) @ eff for (n, ncv) float32 dosages `t`, with p the
    per-column allele frequency. The product runs at full float32
    precision: these values rank individuals for selection, and a
    reduced-precision (TF32) matrix unit would reorder them."""
    p = jnp.mean(t, axis=0) / 2.0
    return jnp.dot(
        t - 2.0 * p[None, :], eff, precision=jax.lax.Precision.HIGHEST
    )


def phenotype_from_cv(cv, eff):
    """Breeding values from the resident (n, 2, ncv) CV matrix, with
    per-generation allele-frequency centering (`Simulation.cpp:2647-2711`,
    additive-only)."""
    return centered_dot((cv[:, 0] + cv[:, 1]).astype(jnp.float32), eff)


def make_reproduce(cfg: PackedConfig):
    """reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu) ->
    (n, 2, mw) child planes: word-mask meiosis of both gametes, then the
    de novo mutation flips (mu: (n, 2, Km) loci or None)."""

    def reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu=None):
        childA = meiose_packed_xla(hap, fathers, xo_p, st_p, cfg)
        childB = meiose_packed_xla(hap, mothers, xo_m, st_m, cfg)
        if mu is not None:
            childA = apply_mutations_packed(childA, mu[:, 0])
            childB = apply_mutations_packed(childB, mu[:, 1])
        return jnp.stack([childA, childB], axis=1)

    return reproduce


def make_step(cfg: PackedConfig, xo_cdf=None):
    """Packed generation step; same law as the byte engine's
    (`dense/step.py:make_step`) — bit-identical after unpacking when driven
    with the same keys. xo_cdf: optional (m,) cumulative-Morgans array for
    map-aware crossovers."""
    reproduce = make_reproduce(cfg)
    dense_cfg = cfg.as_dense()

    def step(state, key):
        hap = state["hap"]
        n_par = hap.shape[0]
        n = cfg.n
        k_mate, k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(key, 5)

        km1, km2, km3 = jax.random.split(k_mate, 3)
        if cfg.selection:
            bv = phenotype_from_cv(state["cv"], state["eff"])
            z = (bv - jnp.mean(bv)) / (jnp.std(bv) + 1e-9)
            fathers = jax.random.categorical(km1, z, shape=(n,))
            mothers = jax.random.categorical(km2, z, shape=(n,))
        else:
            fathers = jax.random.randint(km1, (n,), 0, n_par)
            mothers = jax.random.randint(km2, (n,), 0, n_par)
        if cfg.couples:
            # households: the first n//2 draws act as the couple pool and
            # children land multinomially, sorted so siblings are adjacent
            c = max(n // 2, 1)
            cc = jnp.sort(jax.random.randint(km3, (n,), 0, c))
            fathers = fathers[cc]
            mothers = mothers[cc]

        xo_p, st_p, clip_p = _sample_gamete_plan(k_pat, dense_cfg, n, xo_cdf)
        xo_m, st_m, clip_m = _sample_gamete_plan(k_mat, dense_cfg, n, xo_cdf)
        clip = clip_p + clip_m
        mu = None
        if cfg.mut_rate > 0:
            mu_a, clip_a = mutation_positions(k_mu1, n, cfg)
            mu_b, clip_b = mutation_positions(k_mu2, n, cfg)
            mu = jnp.stack([mu_a, mu_b], axis=1)
            clip = clip + clip_a + clip_b
        child = reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu)
        # advance the resident CV matrix through the SAME meiosis law —
        # zero genome-plane traffic for the phenotype path
        cv = jnp.stack(
            [
                cv_child(state["cv"], fathers, xo_p, st_p,
                         None if mu is None else mu[:, 0],
                         state["cv_idx"], cfg.chr_len),
                cv_child(state["cv"], mothers, xo_m, st_m,
                         None if mu is None else mu[:, 1],
                         state["cv_idx"], cfg.chr_len),
            ],
            axis=1,
        )
        return {
            "hap": child,
            "cv": cv,
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            "clip": state.get("clip", 0) + clip,
        }

    return step
