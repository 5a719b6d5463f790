"""Simulation driver: the vectorized equivalent of `Simulation::run`
(`/root/reference/src/Simulation.cpp:68-161`).

Per-generation control flow mirrors `sim_next_generation`
(`Simulation.cpp:1890-2082`): mate -> reproduce -> A/D -> phenotypes ->
gamma -> MV/SV -> migration -> snapshots -> info files -> optional genotype
output. The genome work (meiosis merges, CV gathers, A/D reductions) runs as
jitted JAX on the default backend; pairing and the O(n) phenotype algebra run
on host in float64.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geneevolve_tpu.config import ScenarioConfig
from geneevolve_tpu.core import mating, phenotype, segments
from geneevolve_tpu.core.rng import Stage, np_seed, root_key, stage_key
from geneevolve_tpu.core.segments import ChromMaps
from geneevolve_tpu.io import hap as hap_io
from geneevolve_tpu.io import tables
from geneevolve_tpu.io import vcf as vcf_io
from geneevolve_tpu.utils import telemetry


def device_memory_budget(stats: Optional[dict]) -> Optional[int]:
    """Bytes a device can hold, from its `memory_stats()`: `GE_HBM_BYTES`
    when set, else `bytes_limit`; None when the device reports no memory
    stats (the CPU backend), which means no memory gate applies."""
    if "GE_HBM_BYTES" in os.environ:
        return int(os.environ["GE_HBM_BYTES"])
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


# --------------------------------------------------------------------------
# jitted genome kernels


def _chr_plan_draws(
    k, nc, xo_cap, mn_cap, has_mut, xo_grid_w, mut_grid_w,
    bp_c, xoc, xol, bw, mbp, mcum, mlam,
    xg, mg, b0, mb0, bstep, mbstep,
):
    """One chromosome's full generation plan (crossovers both gametes,
    start chromatids, de novo mutations + chromatid split) from its
    per-chromosome key. Shared by `_capacity_probe` and `_plan_group` so
    the two are draw-for-draw identical — the capacity guard depends on
    it."""
    big = segments._big()
    k_xo_f, k_xo_m, k_sh, k_mp, k_mc = jax.random.split(k, 5)
    xo_f = segments.sample_point_process(
        k_xo_f, nc, xo_cap, xoc, xol, bp_c, bw, False,
        grid=xg, grid_w=xo_grid_w, bp0=b0, bp_step=bstep,
    )
    xo_m = segments.sample_point_process(
        k_xo_m, nc, xo_cap, xoc, xol, bp_c, bw, False,
        grid=xg, grid_w=xo_grid_w, bp0=b0, bp_step=bstep,
    )
    sh = jax.random.randint(k_sh, (nc, 2), 0, 2)
    if has_mut:
        new = segments.sample_point_process(
            k_mp, nc, mn_cap, mcum, mlam, mbp, 0, True,
            grid=mg, grid_w=mut_grid_w, bp0=mb0, bp_step=mbstep,
        )
        which = jax.random.randint(k_mc, (nc, mn_cap), 0, 2)
        new_f = jnp.where(which == 0, new, big)
        new_m = jnp.where(which == 1, new, big)
    else:
        new = None
        new_f = jnp.full((nc, 1), big, dtype=segments.pos_dtype())
        new_m = new_f
    return xo_f, xo_m, sh, new_f, new_m, new


@partial(
    jax.jit,
    static_argnames=(
        "xo_cap", "mn_cap", "has_mut", "xo_grid_w", "mut_grid_w",
        "emit_plan",
    ),
)
def _capacity_probe(
    par_st,  # (nchr, n, 2, S)
    par_mut,  # (nchr, n, 2, M)
    father,
    mother,
    key,
    bp,
    xo_cum,
    xo_lambda,
    bin_width,
    mut_bp,
    mut_cum,
    mut_lambda,
    xo_cap: int,
    mn_cap: int,
    has_mut: bool,
    xo_grid=None,
    mut_grid=None,
    bp0=None,
    mut_bp0=None,
    bp_step=None,
    mut_bp_step=None,
    xo_grid_w: int = 0,
    mut_grid_w: int = 0,
    emit_plan: bool = True,  # static: False returns only the capacity
    # scalars — the sampled plan dies per chromosome inside the program
    # (the stacked (nchr, n, cap) plan buffers are the peak-HBM driver at
    # biobank n; the per-group mode re-draws them just-in-time)
):
    """Generation plan: samples EVERY random draw of the coming reproduce
    pass (crossover point processes, gamete start chromatids, de novo
    mutations, their chromatid split) and returns the exact ledger-slot /
    (conservative) mutation-slot requirements plus the sampled plan itself.
    Runs before the real pass so capacity growth happens while the old
    state is still alive — the real pass donates the genome buffers
    (halving peak HBM), which makes a redo-after-overflow impossible — and
    the real pass then CONSUMES the plan instead of re-drawing it (the
    samplers are ~40% of the generation's device time at n=300k; drawing
    once instead of twice pays for the plan's ~1.4 GB residency).

    Returns (seg_need, mut_need, plan) with plan = (xo_f, xo_m, sh,
    new_f, new_m) stacked over chromosomes."""
    nc = father.shape[0]

    def per_chr(st, mu, k, bp_c, xoc, xol, bw, mbp, mcum, mlam, ci):
        xg = xo_grid[ci] if xo_grid is not None else None
        mg = mut_grid[ci] if mut_grid is not None else None
        b0 = bp0[ci] if bp0 is not None else None
        mb0 = mut_bp0[ci] if mut_bp0 is not None else None
        bstep = bp_step[ci] if bp0 is not None else None
        mbstep = mut_bp_step[ci] if mut_bp0 is not None else None
        xo_f, xo_m, sh, new_f, new_m, new = _chr_plan_draws(
            k, nc, xo_cap, mn_cap, has_mut, xo_grid_w, mut_grid_w,
            bp_c, xoc, xol, bw, mbp, mcum, mlam,
            xg, mg, b0, mb0, bstep, mbstep,
        )
        nv0 = segments.count_merge_valid(st[father], xo_f, sh[:, 0])
        nv1 = segments.count_merge_valid(st[mother], xo_m, sh[:, 1])
        seg_used = jnp.maximum(jnp.max(nv0), jnp.max(nv1))
        big = segments._big()
        if has_mut:
            mreal = jnp.sum((mu < big).astype(jnp.int32), axis=(1, 2))
            newr = jnp.sum((new < big).astype(jnp.int32), axis=1)
            mut_used = jnp.max(
                jnp.maximum(mreal[father], mreal[mother]) + newr
            )
        else:
            mut_used = jnp.zeros((), dtype=jnp.int32)
        return seg_used, mut_used, xo_f, xo_m, sh, new_f, new_m

    keys = jax.random.split(key, par_st.shape[0])
    # python-unrolled over chromosomes with barrier serialization (same
    # pattern as _ad_all): the earlier lax.map(batch_size=1) wrapper
    # RESHAPED its inputs to (nchr, 1, ...), materializing a full copy of
    # the parent ledger inside the program — 7.9 GB at n=1e6 (measured
    # OOM); indexing slices per iteration copies nothing
    nchr = par_st.shape[0]
    outs = []
    # serialization: each iteration's chromosome INDEX depends on the
    # previous iteration's result (carry is always 0, but XLA cannot know
    # that), so the unrolled bodies cannot be scheduled concurrently —
    # without the dependence every chromosome's kernel temporaries
    # coexist (measured 33 GB at n=1e6; an optimization_barrier on the
    # OUTPUTS does not gate the next iteration's START)
    carry = jnp.zeros((), jnp.int32)
    for ci in range(nchr):
        ci_t = jnp.asarray(ci, jnp.int32) + carry
        r = per_chr(
            par_st[ci_t], par_mut[ci_t], keys[ci_t], bp[ci_t], xo_cum[ci_t],
            xo_lambda[ci_t], bin_width[ci_t], mut_bp[ci_t], mut_cum[ci_t],
            mut_lambda[ci_t], ci_t,
        )
        carry = jnp.clip(r[0].astype(jnp.int32), 0, 0)  # == 0, data-dep
        outs.append(r if emit_plan else r[:2])
    if not emit_plan:
        su = jnp.stack([o[0] for o in outs])
        mu_used = jnp.stack([o[1] for o in outs])
        return jnp.max(su), jnp.max(mu_used), None
    su, mu_used, xo_f, xo_m, sh, new_f, new_m = (
        jnp.stack([o[i] for o in outs]) for i in range(7)
    )
    return (
        jnp.max(su),
        jnp.max(mu_used),
        (xo_f, xo_m, sh, new_f, new_m),
    )


@partial(
    jax.jit,
    static_argnames=(
        "nc", "gn", "xo_cap", "mn_cap", "has_mut", "xo_grid_w",
        "mut_grid_w",
    ),
)
def _plan_group(
    key, c0, nc: int, gn: int,
    bp, xo_cum, xo_lambda, bin_width, mut_bp, mut_cum, mut_lambda,
    xo_cap: int, mn_cap: int, has_mut: bool,
    xo_grid=None, mut_grid=None, bp0=None, mut_bp0=None,
    bp_step=None, mut_bp_step=None,
    xo_grid_w: int = 0, mut_grid_w: int = 0,
):
    """Re-draw the generation plan for chromosomes [c0, c0+gn) only —
    draw-for-draw identical to `_capacity_probe`'s (same key schedule via
    `_chr_plan_draws`; the capacity guard cross-checks every generation).
    The per-group mode keeps only one group's (gn, n, cap) plan alive
    instead of all nchr stacked (the peak-HBM driver at biobank n)."""
    nchr = bp.shape[0]
    keys = jax.random.split(key, nchr)
    outs = []
    for g in range(gn):
        ci = c0 + jnp.asarray(g, dtype=c0.dtype)
        xg = xo_grid[ci] if xo_grid is not None else None
        mg = mut_grid[ci] if mut_grid is not None else None
        b0 = bp0[ci] if bp0 is not None else None
        mb0 = mut_bp0[ci] if mut_bp0 is not None else None
        bstep = bp_step[ci] if bp0 is not None else None
        mbstep = mut_bp_step[ci] if mut_bp0 is not None else None
        xo_f, xo_m, sh, new_f, new_m, _ = _chr_plan_draws(
            keys[ci], nc, xo_cap, mn_cap, has_mut, xo_grid_w, mut_grid_w,
            bp[ci], xo_cum[ci], xo_lambda[ci], bin_width[ci],
            mut_bp[ci], mut_cum[ci], mut_lambda[ci],
            xg, mg, b0, mb0, bstep, mbstep,
        )
        outs.append((xo_f, xo_m, sh, new_f, new_m))
    return tuple(
        jnp.stack([o[i] for o in outs]) for i in range(5)
    )


@partial(
    jax.jit,
    static_argnames=("s_cap", "m_cap", "merge_ibd", "has_mut"),
    # no donation: this path only runs on population-RESIZE generations
    # (child shapes differ from parent shapes, so aliasing is impossible
    # and declaring donation would just emit unusable-buffer warnings);
    # the constant-size path (_reproduce_group_inplace) donates for real
)
def _reproduce_all(
    par_st,  # (nchr, n, 2, S)
    par_hap,
    par_mut,  # (nchr, n, 2, M)
    father,  # (nc,) shared across chromosomes
    mother,
    xo_f,  # (nchr, nc, xo_cap) sampled plan from _capacity_probe
    xo_m,
    sh,  # (nchr, nc, 2)
    new_f,  # (nchr, nc, mn_cap)
    new_m,
    s_cap: int,
    m_cap: int,
    merge_ibd: bool = True,
    has_mut: bool = True,
    cv=None,  # (nchr, n, 2, C) uint8 resident CV alleles, or None
    cv_bp=None,  # (nchr, C) CV positions (all phenotypes concatenated)
):
    """All chromosomes of `reproduce` (`Simulation.cpp:2394-2493`) for all
    children in one compiled call, consuming the plan (crossovers, start
    chromatids, de novo mutations) sampled by `_capacity_probe`.
    `has_mut=False` (no mutation map anywhere) skips the whole mutation
    pipeline statically — the BIG-padded carrier arrays pass through
    untouched. This is the population-resize path (n_children !=
    n_parents): donation cannot alias anyway, so one program batches every
    chromosome; the constant-size path is `_reproduce_group_inplace`.

    `cv` is the resident CV-allele matrix (single-population fast path):
    the child's alleles are the phase-selected parent alleles XOR the de
    novo flips, so `ras_find_cv`'s founder-matrix gathers
    (`Simulation.cpp:2752-2815`) never run after generation 0 — the same
    resident-matrix technique the dense engine uses (DESIGN.md). The
    resident values are bit-identical to re-gathering from the ledger:
    inherited mutations ride along in the copied parent allele, and a de
    novo flip is suppressed where the active parent chromatid already
    carries a mutation at that position (membership, not parity —
    `Simulation.cpp:2961-2970`)."""
    per_chr = _make_per_chr(
        father, mother, s_cap, m_cap, merge_ibd, has_mut, cv, cv_bp,
    )
    nc = father.shape[0]
    xs = (
        par_st, par_hap, par_mut, xo_f, xo_m, sh, new_f, new_m,
        jnp.arange(par_st.shape[0], dtype=jnp.int32),
    )
    if os.environ.get("GE_VMAP_CHR") == "1":
        # batched form: all chromosomes' meioses as one wide program
        c_st, c_hap, c_mut, c_cv, su, mu_used = jax.vmap(per_chr)(*xs)
    else:
        # chunked scan over chromosomes (vmap width GE_CHR_BATCH per
        # iteration): same values as full vmap, ~nchr/b x smaller peak
        # merge scratch, while keeping the compiled program one small
        # body. The merge transients are ~(2S+K)*nc*24 bytes per
        # in-flight chromosome, so the default batch narrows as the child
        # count grows.
        if "GE_CHR_BATCH" in os.environ:
            b = int(os.environ["GE_CHR_BATCH"])
        else:
            # transient budget: the merge materializes ~8 (L, nc) int32
            # arrays per in-flight chromosome (L = 2S+K+1); cap the batch so
            # that stays ~3 GB, and otherwise run every chromosome in one
            # vmapped body (per-fusion launch overheads amortize across the
            # batch axis)
            L = 2 * s_cap + xo_f.shape[-1] + 1
            b = max(1, int(3e9 / (L * max(nc, 1) * 4 * 8)))
        b = max(1, min(b, par_st.shape[0]))
        c_st, c_hap, c_mut, c_cv, su, mu_used = jax.lax.map(
            lambda a: per_chr(*a), xs, batch_size=b
        )
    return c_st, c_hap, c_mut, c_cv, jnp.max(su), jnp.max(mu_used)


def _make_per_chr(
    father, mother, s_cap, m_cap, merge_ibd, has_mut, cv, cv_bp,
):
    """One chromosome's `reproduce` body (two meioses, mutation
    inheritance, resident-CV transport), consuming the pre-sampled plan —
    a closure shared by the all-chromosomes batch (`_reproduce_all`) and
    the in-place path (`_reproduce_group_inplace`). At biobank n the
    children are processed in row chunks (serialized like _capacity_probe)
    so the merge's (L, chunk) transients stay bounded."""
    nc_all = father.shape[0]
    CHN = int(os.environ.get("GE_REPRO_CHUNK", str(1 << 18)))

    def per_chr(st, hp, mu, xo_f, xo_m, sh, new_f, new_m, ci):
        if nc_all <= (1 << 19):
            return _per_chr_rows(
                st, hp, mu, father, mother,
                xo_f, xo_m, sh, new_f, new_m, ci,
            )
        outs = []
        carry = jnp.zeros((), jnp.int32)
        for lo in range(0, nc_all, CHN):
            hi = min(lo + CHN, nc_all)
            # serializing data-dep (carry is always 0)
            fa = jax.lax.dynamic_slice_in_dim(father, lo + carry, hi - lo)
            r = _per_chr_rows(
                st, hp, mu, fa, mother[lo:hi],
                xo_f[lo:hi], xo_m[lo:hi], sh[lo:hi],
                new_f[lo:hi], new_m[lo:hi], ci,
            )
            carry = jnp.clip(r[4].astype(jnp.int32), 0, 0)
            outs.append(r)
        return (
            jnp.concatenate([o[0] for o in outs], axis=0),
            jnp.concatenate([o[1] for o in outs], axis=0),
            jnp.concatenate([o[2] for o in outs], axis=0),
            jnp.concatenate([o[3] for o in outs], axis=0),
            jnp.max(jnp.stack([o[4] for o in outs])),
            jnp.max(jnp.stack([o[5] for o in outs])),
        )

    def _per_chr_rows(
        st, hp, mu, father, mother, xo_f, xo_m, sh, new_f, new_m, ci,
    ):
        nc = father.shape[0]
        cvr = cv[ci] if cv is not None else None  # (n, 2, C)
        q = cv_bp[ci] if cv_bp is not None else None  # (C,)
        st0, hap0, nv0 = segments.meiose(
            st[father], hp[father], xo_f, sh[:, 0], s_cap, merge_ibd
        )
        st1, hap1, nv1 = segments.meiose(
            st[mother], hp[mother], xo_m, sh[:, 1], s_cap, merge_ibd
        )
        child_st = jnp.stack([st0, st1], axis=1)
        child_hap = jnp.stack([hap0, hap1], axis=1)

        if has_mut:
            # new_f/new_m: the plan's de novo mutations, already split by
            # chromatid (BIG-masked complements of one sampled point set)
            mut0, nm0 = segments.inherit_mutations(
                mu[father], xo_f, sh[:, 0], new_f, m_cap
            )
            mut1, nm1 = segments.inherit_mutations(
                mu[mother], xo_m, sh[:, 1], new_m, m_cap
            )
            child_mut = jnp.stack([mut0, mut1], axis=1)
            mut_used = jnp.maximum(jnp.max(nm0), jnp.max(nm1))
        else:
            child_mut = jnp.full(
                (nc, 2, mu.shape[-1]), segments._big(),
                dtype=segments.pos_dtype(),
            )
            mut_used = jnp.zeros((), dtype=jnp.int32)

        if cvr is not None:
            def gamete_cv(par_idx, xo, sh_g, new_g):
                par = cvr[par_idx]  # (nc, 2, C) row gather
                phase = (
                    sh_g[:, None]
                    + jnp.sum(
                        (xo[:, :, None] <= q[None, None, :]).astype(
                            jnp.int32
                        ),
                        axis=1,
                    )
                ) % 2  # (nc, C)
                g = jnp.where(phase == 0, par[:, 0, :], par[:, 1, :])
                if has_mut:
                    pm = mu[par_idx]  # (nc, 2, M)
                    hit = lambda rows: jnp.any(
                        rows[:, :, None] == q[None, None, :], axis=1
                    )
                    carried = jnp.where(
                        phase == 0, hit(pm[:, 0]), hit(pm[:, 1])
                    )
                    flip = hit(new_g) & ~carried
                    g = jnp.where(flip, 1 - g, g)
                return g.astype(jnp.uint8)

            nf = new_f if has_mut else None
            nm = new_m if has_mut else None
            child_cv = jnp.stack(
                [
                    gamete_cv(father, xo_f, sh[:, 0], nf),
                    gamete_cv(mother, xo_m, sh[:, 1], nm),
                ],
                axis=1,
            )  # (nc, 2, C)
        else:
            # 1-wide dummy (zero-size arrays break lax.map's unbatching)
            child_cv = jnp.zeros((nc, 2, 1), dtype=jnp.uint8)
        seg_used = jnp.maximum(jnp.max(nv0), jnp.max(nv1))
        return child_st, child_hap, child_mut, child_cv, seg_used, mut_used

    return per_chr


@partial(
    jax.jit,
    static_argnames=(
        "gn", "s_cap", "m_cap", "merge_ibd", "has_mut", "plan_local",
    ),
    donate_argnames=("par_st", "par_hap", "par_mut", "cv"),
)
def _reproduce_group_inplace(
    par_st,  # (nchr, n, 2, S) — donated; children overwrite chrs c0..c0+gn
    par_hap,
    par_mut,
    father,  # (n,)
    mother,
    xo_f,  # (nchr, n, xo_cap) sampled plan (from _capacity_probe)
    xo_m,
    sh,  # (nchr, n, 2)
    new_f,  # (nchr, n, mn_cap)
    new_m,
    c0,  # () int32 — first chromosome of the group (traced: one program
    #       serves every group of width gn)
    gn: int,
    s_cap: int,
    m_cap: int,
    merge_ibd: bool = True,
    has_mut: bool = True,
    cv=None,
    cv_bp=None,
    plan_local: bool = False,  # static: plan args are already the
    # group's (gn, ...) slices (per-group plan mode) — don't slab them
):
    """A group of gn chromosomes of `reproduce`, updating the stacked
    genome planes IN PLACE (donated buffers + dynamic-update-slice alias,
    so the child rows land in the parents' HBM). This is the
    constant-population-size path: the all-chromosomes `_reproduce_all`
    scan cannot alias its donated inputs to the stacked scan outputs (the
    last chromosome still reads the input when the first output slab is
    written), so its peak HBM is 2x state + merge transients — which OOMs
    a 16 GB chip at the reference's 300k x 22-chr Table 3.1 shape.
    Chaining these group programs keeps peak at ~1x state + one
    chromosome's transients (the group iterates its chromosomes with an
    internal batch of 1), while grouping amortizes the per-dispatch
    overhead. Chromosome ci
    consumes plan rows [ci], exactly as the batched path does — the two
    formulations are bit-identical."""
    per_chr = _make_per_chr(
        father, mother, s_cap, m_cap, merge_ibd, has_mut, cv, cv_bp,
    )
    z = jnp.zeros((), dtype=c0.dtype)

    def slab(x):
        sizes = (gn,) + x.shape[1:]
        return jax.lax.dynamic_slice(x, (c0,) + (z,) * (x.ndim - 1), sizes)

    def pslab(x):
        return x if plan_local else slab(x)

    xs = (
        slab(par_st), slab(par_hap), slab(par_mut),
        pslab(xo_f), pslab(xo_m), pslab(sh), pslab(new_f), pslab(new_m),
        c0 + jnp.arange(gn, dtype=c0.dtype),
    )
    # unrolled (NOT lax.map): the scan wrapper's staging boundaries cost
    # ~30% of the whole pass (measured 17.6 vs 13.4 s/gen at n=300k)
    per = [
        per_chr(*(x[i] for x in xs[:-1]), xs[-1][i]) for i in range(gn)
    ]
    c_st, c_hap, c_mut, c_cv = (
        jnp.stack([p[j] for p in per]) for j in range(4)
    )
    su = jnp.max(jnp.stack([p[4] for p in per]))
    mu_used = jnp.max(jnp.stack([p[5] for p in per]))
    start = (c0, z, z, z)
    out_st = jax.lax.dynamic_update_slice(par_st, c_st, start)
    out_hap = jax.lax.dynamic_update_slice(
        par_hap, c_hap.astype(par_hap.dtype), start
    )
    out_mut = jax.lax.dynamic_update_slice(par_mut, c_mut, start)
    if cv is not None:
        out_cv = jax.lax.dynamic_update_slice(cv, c_cv, start)
    else:
        out_cv = None
    return out_st, out_hap, out_mut, out_cv, su, mu_used


@partial(jax.jit, static_argnames=("want_cv", "counts_only"))
def _ad_all(
    seg_st,  # (nchr, n, 2, S)
    seg_hap,
    mut,  # (nchr, n, 2, M)
    cv_bp,  # (nchr, ncv) — zero-effect padding columns
    founder_cv,  # (nchr, H, ncv)
    a_tab,  # (nchr, npop, ncv)
    d_tab,
    pop_starts,  # (npop,)
    dominance_on,  # () bool
    n_real,  # () int32 — rows >= n_real are mesh padding
    want_cv: bool = True,  # static: stack the (nchr, n, 2, ncv) allele
    # dump (--debug .cvval); False keeps peak memory at ~1 chromosome's
    # temporaries (a stacked int32 dump alone is 17.7 GB at n=1e6)
    counts_only: bool = False,  # static: return only the (nchr, ncv)
    # global allele counts of this row block (pass 1 of the chunked path)
    counts=None,  # (nchr, ncv) int32 precomputed GLOBAL counts (pass 2)
    n_freq=None,  # () int32 population size behind `counts`
):
    """One phenotype's A/D for every individual, all chromosomes in one
    compiled call: the vectorized `ras_find_cv` + `ras_compute_AD`
    (`Simulation.cpp:2752-2815, 2624-2749`). With `want_cv` also returns
    the per-chromatid CV alleles (nchr, n, 2, ncv) for the --debug .cvval
    dump (a zero-size placeholder otherwise)."""

    def per_chr(st, hp, mu, bp_c, fcv, at, dt, cnt_c):
        hidx = segments.hap_at(st, hp, bp_c)  # (n, 2, ncv)
        ncv = bp_c.shape[0]
        g = fcv[hidx, jnp.arange(ncv)[None, None, :]]
        flip = segments.mutation_flip_mask(
            mu, jnp.broadcast_to(bp_c, hidx.shape)
        )
        c = jnp.where(flip, 1 - g, g).astype(jnp.uint8)
        if counts_only:
            valid = jnp.arange(c.shape[0]) < n_real
            t = (c[:, 0] + c[:, 1]).astype(jnp.int32)
            return jnp.sum(jnp.where(valid[:, None], t, 0), axis=0)
        root = jnp.searchsorted(pop_starts, hidx, side="right") - 1
        icv = jnp.arange(ncv)[None, :]
        A, D = phenotype.additive_dominance_chr(
            c[:, 0],
            c[:, 1],
            at[root[:, 0], icv],
            at[root[:, 1], icv],
            dt[root[:, 0], icv],
            dt[root[:, 1], icv],
            dominance_on,
            n_real,
            tsum=cnt_c,
            n_freq=n_freq if cnt_c is not None else None,
        )
        return A, D, c

    # unrolled accumulation over chromosomes: the earlier 22-wide vmap
    # materialized every chromosome's (n, 2, ncv) gather temporaries at
    # once (17.7 GB at n=1e6); a python-unrolled sum lets XLA reuse one
    # chromosome's buffers.
    nchr = seg_st.shape[0]
    if counts_only:
        cnts = []
        carry = jnp.zeros((), jnp.int32)
        for ci in range(nchr):
            ci_t = jnp.asarray(ci, jnp.int32) + carry
            t = per_chr(
                seg_st[ci_t], seg_hap[ci_t], mut[ci_t], cv_bp[ci_t],
                founder_cv[ci_t], a_tab[ci_t], d_tab[ci_t], None,
            )
            carry = jnp.clip(t[0], 0, 0)  # == 0: serializing data-dep
            cnts.append(t)
        return jnp.stack(cnts)
    A = D = jnp.zeros((), dtype=jnp.float32)
    cs = []
    # serializing index dependence, as in _capacity_probe: one
    # chromosome's ~1 GB gather temporaries must die before the next
    # iteration's allocate
    carry = jnp.zeros((), jnp.int32)
    for ci in range(nchr):
        ci_t = jnp.asarray(ci, jnp.int32) + carry
        A_c, D_c, c_c = per_chr(
            seg_st[ci_t], seg_hap[ci_t], mut[ci_t], cv_bp[ci_t],
            founder_cv[ci_t], a_tab[ci_t], d_tab[ci_t],
            None if counts is None else counts[ci_t],
        )
        A = A + A_c
        D = D + D_c
        carry = jnp.clip(A_c[0].astype(jnp.int32), 0, 0)
        if want_cv:
            cs.append(c_c)
    c = jnp.stack(cs) if want_cv else jnp.zeros(
        (nchr, 0, 2, 0), dtype=jnp.uint8
    )
    return A, D, c


@jax.jit
def _ad_resident(
    cv,  # (nchr, n, 2, ncv) uint8 resident CV alleles (one phenotype)
    a_row,  # (nchr, ncv) — the single population's additive effects
    d_row,
    dominance_on,  # () bool
    n_real,  # () int32
):
    """A/D from the resident CV matrix (single-population fast path): no
    ledger probes, no founder-matrix gathers — `ras_compute_AD`
    (`Simulation.cpp:2624-2749`) as pure elementwise math + reductions.
    Bit-identical to `_ad_all`: the resident alleles equal the gathered
    ones by construction and the float math is the same function."""

    def per_chr(c, at, dt):
        a_b = jnp.broadcast_to(at[None, :], c[:, 0].shape)
        d_b = jnp.broadcast_to(dt[None, :], c[:, 0].shape)
        return phenotype.additive_dominance_chr(
            c[:, 0], c[:, 1], a_b, a_b, d_b, d_b, dominance_on, n_real
        )

    # sequential unrolled accumulation, SAME order as _ad_all: the two
    # paths stay bit-identical (a tree/vmap reduction reassociates f32),
    # and one chromosome's (n, ncv) f32 temporaries die before the next
    # allocates (serializing index dependence, see _capacity_probe)
    nchr = cv.shape[0]
    A = D = jnp.zeros((), dtype=jnp.float32)
    carry = jnp.zeros((), jnp.int32)
    for ci in range(nchr):
        ci_t = jnp.asarray(ci, jnp.int32) + carry
        A_c, D_c = per_chr(cv[ci_t], a_row[ci_t], d_row[ci_t])
        A = A + A_c
        D = D + D_c
        carry = jnp.clip(A_c[0].astype(jnp.int32), 0, 0)
    return A, D


@jax.jit
def _moments_jit(x):
    # f32 tree-reduction sums (x64 is off); the NR consumer tolerates
    # ~1e-5 relative moment error at biobank n
    return jnp.sum(x), jnp.sum(x * x)


# --------------------------------------------------------------------------
# runtime state


@dataclass
class PhenoScheme:
    """Static per-phenotype data for one population."""

    cv_bp: List[np.ndarray]  # per chr
    a: List[np.ndarray]  # per chr, this population's additive effects
    d: List[np.ndarray]
    founder_cv: List[np.ndarray]  # per chr (2n0, ncv) uint8, this pop's founders
    va: float
    vd: float
    vc: float
    ve: float
    vf: float
    omega: float
    beta: float
    lambda_: float


@dataclass
class PopState:
    """One population's current generation. Genome state is stacked over
    chromosomes (axis 0) so one compiled kernel serves all of them; when a
    mesh is attached the individuals axis (axis 1) is sharded."""

    n: int
    seg_st: jax.Array  # (nchr, n, 2, S)
    seg_hap: jax.Array
    mut: jax.Array  # (nchr, n, 2, M)
    # resident CV alleles (nchr, n, 2, npheno*ncv_pad) uint8 — the
    # single-population fast path for A/D; None in multi-population runs
    cv: Optional[jax.Array] = None
    sex: np.ndarray = None  # (n,) 1/2
    ids: np.ndarray = None  # (n,) 0-based birth id
    ped: Dict[str, np.ndarray] = None  # father, mother, ff, fm, mf, mm
    comp: Dict[str, np.ndarray] = None  # A D G C E F P -> (npheno, n)
    mv: np.ndarray = None
    sv: np.ndarray = None  # standardized selection value
    svf: np.ndarray = None  # selection probability


@dataclass
class PopRuntime:
    index: int
    schedule: tables.GenerationSchedule
    chrs: List[int]
    rmaps: Dict[int, tables.RecombinationMap]
    maps: List[ChromMaps]  # ordered as chrs
    phenos: List[PhenoScheme]
    indv_ids: List[str]
    n_founders: int
    hap_offset: int  # global founder-hap index offset
    mm_percent: float
    rm: bool
    hap_addresses: List = field(default_factory=list)  # (chr, hap, legend, indv)
    vcf_addresses: List = field(default_factory=list)  # (chr, vcf)
    smaps: Optional[segments.StackedMaps] = None
    state: Optional[PopState] = None
    prev_phen: Optional[np.ndarray] = None  # (npheno, n_prev) by position
    prev_F: Optional[np.ndarray] = None
    var_a_gen0: Optional[np.ndarray] = None  # (npheno,)
    var_d_gen0: Optional[np.ndarray] = None
    sv_mean_gen0: float = 0.0
    sv_var_gen0: float = 0.0
    traj: Dict[str, np.ndarray] = field(default_factory=dict)


class SimulationError(RuntimeError):
    pass


class Simulation:
    """End-to-end scenario runner."""

    def __init__(self, cfg: ScenarioConfig, verbose: bool = True, mesh=None):
        """`mesh`: optional jax.sharding.Mesh with an 'ind' axis; when given,
        every genome array is sharded over individuals and the jitted genome
        kernels run SPMD across the mesh (results are bit-identical to the
        unsharded run: the only cross-individual reduction, the CV allele
        count, is integer)."""
        self.cfg = cfg
        self.verbose = verbose
        self.key = root_key(cfg.seed)
        self.n_pop = cfg.n_pop
        self.n_pheno = cfg.n_pheno
        self.vt_type = cfg.vt_type
        self.pops: List[PopRuntime] = []
        self.timer = telemetry.StageTimer()
        self.mesh = mesh
        if mesh is not None and "ind" not in mesh.axis_names:
            raise SimulationError("mesh must have an 'ind' axis")
        # .int output needs the crossover-split ledger (reference part
        # structure, `Simulation.cpp:1582-1639`); otherwise merge
        # IBD-adjacent boundaries for a smaller ledger
        self.merge_ibd = not cfg.out_interval
        # (seg_used, mut_used, s_cap, m_cap, gen, pop) tuples awaiting the
        # deferred overflow check (see _check_capacity_guard)
        self._pending_used: list = []
        # background writer for the per-generation info files (_save_info)
        from concurrent.futures import ThreadPoolExecutor

        self._io_pool = ThreadPoolExecutor(max_workers=1)
        self._io_futures: list = []
        # realized-N law: False = reference Poisson(pop_size) generation
        # sizes (`Simulation.cpp:2329-2337`); True = condition on exactly
        # pop_size (fixed-shape engines; dense backend sets this)
        self.exact_n = os.environ.get("GE_EXACT_N") == "1"
        self._load()

    def _check_capacity_guard(self) -> None:
        """Verify the previous real pass stayed within the capacities the
        probe promised. The probe and the real pass are separately compiled
        programs sharing an RNG key schedule; if they ever drift (key-split
        order, sampler structure, count formula), the rank compaction would
        silently truncate valid boundaries — corrupted genomes with no
        error. This fetch turns that into a hard failure one generation
        late."""
        pending, self._pending_used = self._pending_used, []
        for seg_used, mut_used, s_cap, m_cap, gen, pop in pending:
            su, mu = int(seg_used), int(mut_used)
            if su > s_cap or mu > m_cap:
                raise SimulationError(
                    f"capacity guard tripped at gen {gen} pop {pop}: "
                    f"real pass used seg={su}/{s_cap} mut={mu}/{m_cap} — "
                    f"_capacity_probe drifted from _reproduce_all"
                )

    def _pad_n(self, n: int) -> int:
        """Individuals-axis size padded to a mesh multiple (devices require
        equal shards; padding rows are masked out of every statistic and
        sliced off every output)."""
        if self.mesh is None:
            return n
        m = self.mesh.shape["ind"]
        return ((n + m - 1) // m) * m

    def _child_rows(self, p: PopRuntime, gen: int, n_child: int,
                    par_rows: int) -> int:
        """Plane-row count for a generation of `n_child` children.

        Realized-N jitter absorption: under the Poisson offspring law the
        realized size wobbles ~pop_size +- sqrt(pop_size) per generation.
        Reusing the parents' plane rows (when they fit and are plausibly
        jitter- not schedule-sized) keeps shapes constant so the reproduce
        program is reused instead of recompiling every generation; fresh
        allocations take ~4-sigma headroom so later generations fit too.
        Padding rows are meioses of parent 0 (draws are prefix-stable in
        the leading axis), masked out of every statistic and sliced off
        every output. Shared by the segment and dense backends."""
        n_pad = self._pad_n(n_child)
        g = gen - 1
        law_p = not p.rm and p.schedule.offspring_dist[g] not in ("f", "F")
        if law_p and not self.exact_n:
            sigma = int(np.sqrt(max(n_child, 1)))
            hi = self._pad_n(n_child + 8 * sigma + 64)
            if n_pad <= par_rows <= hi:
                n_pad = par_rows
            else:
                n_pad = self._pad_n(n_child + 4 * sigma + 16)
        return n_pad

    def _put(self, x: jax.Array) -> jax.Array:
        """Pin a stacked genome array (nchr, n, ...) to the mesh: sharded
        over individuals (axis 1, edge-padded to a mesh multiple),
        replicated over chromosomes."""
        if self.mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        n_pad = self._pad_n(x.shape[1])
        if n_pad != x.shape[1]:
            pad = [(0, 0)] * x.ndim
            pad[1] = (0, n_pad - x.shape[1])
            x = jnp.pad(x, pad, mode="edge")
        spec = PartitionSpec(*([None, "ind"] + [None] * (x.ndim - 2)))
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------ load
    def _load(self) -> None:
        cfg = self.cfg
        hap_offset = 0
        tot_gen = None
        for ipop, pcfg in enumerate(cfg.populations):
            schedule = tables.read_generation_info(pcfg.file_gen_info)
            if tot_gen is None:
                tot_gen = schedule.n_generations
            elif tot_gen != schedule.n_generations:
                raise SimulationError(
                    "the number of generations differs between populations"
                )
            if pcfg.file_ref_vcf:
                addresses = tables.read_vcf_address(pcfg.file_ref_vcf)
                chrs = [a[0] for a in addresses]
                indv_ids = vcf_io.read_header_samples(addresses[0][1])
                hap_addr, vcf_addr = [], addresses
            else:
                hap_addr = tables.read_hap_address(pcfg.file_hap_name)
                vcf_addr = []
                chrs = [a[0] for a in hap_addr]
                # cross-check .indv line count vs hap column count per
                # chromosome, and equality across chromosomes, at load
                # (`Simulation.cpp:290-320`, `format_hap.cpp:160-183`) —
                # a mismatched panel must fail here, not at output time
                n_per_chr = []
                for _c, f_hap, _f_leg, f_indv in hap_addr:
                    with open(f_hap) as fh:
                        hap_ncol = len(fh.readline().split())
                    with open(f_indv) as fi:
                        # whitespace tokens, matching read_indv and the
                        # reference's `ifile >> id` tokenization
                        indv_nrow = len(fi.read().split())
                    if indv_nrow * 2 != hap_ncol:
                        raise SimulationError(
                            f"Number of individuals are not equal in files "
                            f"[{f_hap}] and [{f_indv}]."
                        )
                    n_per_chr.append(indv_nrow)
                if any(x != n_per_chr[0] for x in n_per_chr):
                    raise SimulationError(
                        "Number of individuals are not equal in different "
                        "chromosomes."
                    )
                indv_ids = hap_io.read_indv(hap_addr[0][3])
            rmaps = tables.read_recom_map(pcfg.file_recom_map, chrs)
            mmaps = (
                tables.read_mutation_map(pcfg.file_mutation_map, chrs)
                if pcfg.file_mutation_map
                else None
            )
            maps = [
                ChromMaps.build(c, rmaps[c], mmaps[c] if mmaps else None)
                for c in chrs
            ]
            if cfg.debug:
                # map spot-checks (`Population.cpp:400-411, 497-505`)
                for c, m in zip(chrs, maps):
                    r = rmaps[c]
                    tail = " ".join(f"{v:g}" for v in r.cM[-20:])
                    print(f"  rmap bp distance in chr {c}={r.bin_width}")
                    print(f"  rmap: {tail}")
                    p = r.prob
                    print(
                        f"  mean(recom_prob)={np.mean(p):g}, "
                        f"recom_prob[end]={p[-1]:g}"
                    )
            phenos = []
            n_founders = None
            for ph in pcfg.phenotypes:
                cv_info = tables.read_cv_info(ph.file_cv_info, chrs)
                cv_addr = tables.read_cvs_address(ph.file_cvs, chrs)
                founder_cv, cv_bp, a_eff, d_eff = [], [], [], []
                for c in chrs:
                    mat = hap_io.read_hap(cv_addr[c])  # (2n0, ncv_chr)
                    ncv_c = len(cv_info[c].bp)
                    if mat.shape[1] < ncv_c:
                        raise SimulationError(
                            "fewer CVs in cv.hap than cv.info file "
                            f"(chr {c}: {mat.shape[1]} < {ncv_c})"
                        )
                    # v1.5.0 semantics: the CV hap file may carry more rows
                    # than cv.info lists; only the first ncv_info are ever
                    # indexed (`Simulation.cpp:2762-2767` loops icv<ncv from
                    # cv_info; `Population.cpp:314-343` loads the whole file
                    # unchecked). Example2.zip relies on this (300-row CV hap
                    # files vs 50 cv.info rows per chromosome).
                    mat = mat[:, :ncv_c]
                    if n_founders is None:
                        n_founders = mat.shape[0] // 2
                    elif n_founders != mat.shape[0] // 2:
                        raise SimulationError(
                            "founder count differs between CV hap files"
                        )
                    founder_cv.append(mat)
                    cv_bp.append(cv_info[c].bp)
                    a_eff.append(cv_info[c].a)
                    d_eff.append(cv_info[c].d)
                phenos.append(
                    PhenoScheme(
                        cv_bp=cv_bp,
                        a=a_eff,
                        d=d_eff,
                        founder_cv=founder_cv,
                        va=ph.va,
                        vd=ph.vd,
                        vc=ph.vc,
                        ve=ph.ve,
                        vf=ph.vf,
                        omega=ph.omega,
                        beta=ph.beta,
                        lambda_=ph.lambda_,
                    )
                )
            if n_founders is None:
                raise SimulationError("no phenotypes configured")
            self.pops.append(
                PopRuntime(
                    index=ipop,
                    schedule=schedule,
                    chrs=chrs,
                    rmaps=rmaps,
                    maps=maps,
                    phenos=phenos,
                    indv_ids=list(indv_ids),
                    n_founders=n_founders,
                    hap_offset=hap_offset,
                    mm_percent=pcfg.mm_percent,
                    rm=pcfg.rm,
                    hap_addresses=hap_addr,
                    vcf_addresses=vcf_addr,
                )
            )
            hap_offset += 2 * n_founders

        self.tot_gen = int(tot_gen)
        self.chrs = self.pops[0].chrs
        for p in self.pops[1:]:
            if p.chrs != self.chrs:
                raise SimulationError(
                    "all populations must use the same chromosome set"
                )
        self.pop_starts = jnp.asarray(
            np.array([p.hap_offset for p in self.pops]), dtype=jnp.int32
        )
        # stacked per-chromosome maps (one compiled kernel for all chrs)
        for p in self.pops:
            p.smaps = segments.StackedMaps.build(p.maps)

        # global CV matrices + per-pop effect tables, stacked over
        # chromosomes and padded to a common CV count with zero-effect
        # columns (they gather real alleles but contribute nothing to A/D),
        # so every (phenotype, generation) A/D call shares one compilation
        self.global_cv: List[jax.Array] = []  # [pheno] (nchr, H, ncv)
        self.eff_a: List[jax.Array] = []  # [pheno] (nchr, npop, ncv)
        self.eff_d: List[jax.Array] = []
        self.cv_bp_dev: List[jax.Array] = []  # [pheno] (nchr, ncv)
        self.ncv_real: List[List[int]] = []  # [pheno][chr] pre-pad counts
        nchr = len(self.chrs)
        H = sum(2 * p.n_founders for p in self.pops)
        ncv_max = max(
            (
                len(p.phenos[j].cv_bp[ic])
                for p in self.pops
                for j in range(self.n_pheno)
                for ic in range(nchr)
            ),
            default=0,
        )
        for j in range(self.n_pheno):
            gc = np.zeros((nchr, H, max(ncv_max, 1)), dtype=np.uint8)
            ga = np.zeros((nchr, self.n_pop, max(ncv_max, 1)), dtype=np.float32)
            gd = np.zeros_like(ga)
            gb = np.zeros((nchr, max(ncv_max, 1)), dtype=np.int64)
            real = []
            for ic, c in enumerate(self.chrs):
                bp0 = self.pops[0].phenos[j].cv_bp[ic]
                for p in self.pops[1:]:
                    if not np.array_equal(p.phenos[j].cv_bp[ic], bp0):
                        raise SimulationError(
                            "CV positions must agree across populations "
                            f"(phenotype {j + 1}, chr {c})"
                        )
                k = len(bp0)
                real.append(k)
                # padding columns probe the chromosome start (harmless)
                gb[ic, :] = self.pops[0].maps[ic].chr_start
                if k:
                    gb[ic, :k] = bp0
                    gc[ic, :, :k] = np.concatenate(
                        [p.phenos[j].founder_cv[ic] for p in self.pops]
                    )
                    ga[ic, :, :k] = np.stack(
                        [p.phenos[j].a[ic] for p in self.pops]
                    )
                    gd[ic, :, :k] = np.stack(
                        [p.phenos[j].d[ic] for p in self.pops]
                    )
            self.global_cv.append(jnp.asarray(gc))
            self.eff_a.append(jnp.asarray(ga))
            self.eff_d.append(jnp.asarray(gd))
            self.cv_bp_dev.append(jnp.asarray(gb, dtype=segments.pos_dtype()))
            self.ncv_real.append(real)

        # resident CV-allele fast path: single population only (the A/D
        # effect tables are root-population-resolved per chromatid via the
        # founder hap index, which the resident matrix does not carry).
        # Whether it actually stays resident is decided below, once the
        # ledger capacities are known (HBM budget check at biobank n).
        self.ncv_pad = max(ncv_max, 1)

        # migration / output-generation list
        self.migration = (
            tables.read_migration(cfg.file_migration, self.n_pop, self.tot_gen)
            if self.n_pop > 1
            else None
        )
        self.out_gens = (
            tables.read_output_generations(cfg.file_output_generations)
            if cfg.file_output_generations
            else []
        )

        # capacities: uniform across chromosomes (sized for the largest map)
        # so every chromosome shares one compiled kernel. s_cap covers the
        # ~Poisson(G*L) boundary count to ~5e-10 per chromatid-generation
        # (expected exceedances < 0.01 even at 300k x 22 chr x 10 gens);
        # the host regrow loop in _reproduce catches the tail exactly.
        G = self.tot_gen
        L = max(
            m.xo_lambda for p in self.pops for m in p.maps
        )
        lam_m = max(m.mut_lambda for p in self.pops for m in p.maps)
        gl = max(G * L, 1.0)
        self.s_cap = int(8 + np.ceil(gl + 6 * np.sqrt(gl)))
        self.xo_cap = int(8 + np.ceil(L + 6 * np.sqrt(max(L, 1.0))))
        if lam_m > 0:
            gm = G * lam_m
            self.m_cap = int(8 + np.ceil(gm + 6 * np.sqrt(max(gm, 1.0))))
            self.mn_cap = int(
                4 + np.ceil(lam_m + 6 * np.sqrt(max(lam_m, 0.25)))
            )
            self.has_mut = True
        else:  # no mutation map: keep the (always-BIG) planes minimal
            self.m_cap = 2
            self.mn_cap = 2
            self.has_mut = False
        # founder-hap indices fit int16 up to 32k haplotypes — half the
        # hap plane at reference-scale n
        H_tot = sum(2 * p.n_founders for p in self.pops)
        self.hap_dtype = jnp.int16 if H_tot <= 32000 else jnp.int32

        # resident-CV residency decision (deferred from the CV-table build
        # above so the projected ledger state is known): the
        # (nchr, n, 2, npheno*ncv_pad) uint8 matrix is ~4.4 GB at n=1e6 /
        # 2,200 CVs.  When state + matrix would not fit the device budget,
        # fall back to the bit-identical gather path (_ad_all re-derives
        # the alleles from the ledger each generation — slower, smaller).
        self.resident_cv = (
            self.n_pop == 1
            and os.environ.get("GE_NO_RESIDENT_CV") != "1"
        )
        budget = device_memory_budget(jax.devices()[0].memory_stats())
        if self.resident_cv and budget is not None:
            max_n = max(
                int(s) for p in self.pops for s in p.schedule.pop_size
            )
            n_pad = max_n + 4 * int(np.sqrt(max_n)) + 16  # law-path rows
            nchr_ = max(len(p.maps) for p in self.pops)
            pos_b = 8 if jax.config.jax_enable_x64 else 4
            hap_b = 2 if self.hap_dtype == jnp.int16 else 4
            state_b = nchr_ * n_pad * 2 * (
                self.s_cap * (pos_b + hap_b) + self.m_cap * pos_b
            )
            cv_b = nchr_ * n_pad * 2 * self.n_pheno * self.ncv_pad
            if state_b + cv_b > int(0.92 * budget):
                self.resident_cv = False
                self._log(
                    "    [mem] resident CV matrix "
                    f"({cv_b / 2**30:.1f} GiB) + ledger state "
                    f"({state_b / 2**30:.1f} GiB) exceeds the device budget "
                    f"({budget / 2**30:.2f} GiB); using the gather path"
                )
        if self.resident_cv:
            # (nchr, npheno*ncv_pad): all phenotypes' CV positions on one
            # axis, in cv_bp_dev order
            self.cv_bp_all = jnp.concatenate(
                [self.cv_bp_dev[j] for j in range(self.n_pheno)], axis=1
            )
        else:
            self.cv_bp_all = None

        # trajectories
        for p in self.pops:
            z = np.zeros((self.n_pheno, G + 1))
            p.traj = {
                k: z.copy() for k in ("var_A", "var_D", "var_G", "var_C",
                                       "var_E", "var_F", "var_P", "h2")
            }
            p.traj["var_mv"] = np.zeros(G + 1)
            p.traj["var_sv"] = np.zeros(G + 1)

    # ------------------------------------------------------------------ gen0
    def init_generation0(self) -> None:
        for p in self.pops:
            p.state = self._init_gen0_state(p)
        self._init_gen0_phenotypes()

    def _gen0_host_fields(self, p: PopRuntime, n: int) -> dict:
        """Founder sex/ids/pedigree (self-parent IDs,
        `ras_initial_human_gen0`, `Simulation.cpp:3036-3044`) — shared by
        every genome backend."""
        rng_sex = np.random.default_rng(
            np_seed(self.cfg.seed, 0, Stage.INIT_SEX, p.index)
        )
        ids = np.arange(n, dtype=np.int64)
        return dict(
            n=n,
            sex=rng_sex.integers(1, 3, size=n).astype(np.int8),
            ids=ids,
            ped={k: ids.copy() for k in ("father", "mother", "ff", "fm",
                                          "mf", "mm")},
            comp={},
            mv=np.zeros(n),
            sv=np.zeros(n),
            svf=np.ones(n),
        )

    def _gen0_rows(self, p: PopRuntime, n0: int) -> int:
        """Plane rows for the gen-0 state: padded up to the row count the
        generation-1 children will use, so the gen-1 reproduce/probe
        programs have the SAME shapes as the steady-state ones — one
        compile instead of two for each of the big programs. Padding rows
        are edge copies (valid hap indices), masked from every statistic
        via PopState.n and never gathered as parents. GE_NO_PAD_GEN0=1
        restores exact-n0 planes."""
        if os.environ.get("GE_NO_PAD_GEN0") == "1":
            return n0
        pop1 = int(p.schedule.pop_size[0])
        law = p.schedule.offspring_dist[0]
        if p.rm or law in ("f", "F") or self.exact_n:
            target = self._pad_n(pop1)
        else:
            sigma = int(np.sqrt(max(pop1, 1)))
            target = self._pad_n(pop1 + 4 * sigma + 16)
        return max(n0, target)

    def _init_gen0_state(self, p: PopRuntime) -> PopState:
        """Backend hook: founder genome state (segment-ledger form here)."""
        n = p.n_founders
        rows = self._gen0_rows(p, n)
        chr_starts = np.array([m.chr_start for m in p.maps])
        seg_st, seg_hap = segments.init_gen0_ledger_stacked(
            n, chr_starts, p.hap_offset, self.s_cap, self.hap_dtype,
            rows=rows,
        )
        mut = segments.empty_mutations_stacked(
            len(self.chrs), rows, self.m_cap
        )
        cv0 = None
        if self.resident_cv:
            # founder i's chromatids read founder haps 2i / 2i+1 directly
            # (`ras_initial_human_gen0`, `Simulation.cpp:3024-3035`)
            cv0 = jnp.concatenate(
                [
                    jnp.stack(
                        [
                            self.global_cv[j][:, 0 : 2 * n : 2, :],
                            self.global_cv[j][:, 1 : 2 * n : 2, :],
                        ],
                        axis=2,
                    )
                    for j in range(self.n_pheno)
                ],
                axis=3,
            )  # (nchr, n, 2, npheno*ncv_pad)
        if rows > n and cv0 is not None:
            # edge-pad the resident CV matrix host-side, like the ledger
            # (init_gen0_ledger_stacked)
            c = np.asarray(cv0)
            cv0 = jnp.asarray(
                np.concatenate(
                    [c, np.repeat(c[:, -1:], rows - n, axis=1)], axis=1
                )
            )
        return PopState(
            seg_st=self._put(seg_st),
            seg_hap=self._put(seg_hap),
            mut=self._put(mut),
            cv=self._put(cv0) if cv0 is not None else None,
            **self._gen0_host_fields(p, n),
        )

    def _init_gen0_phenotypes(self) -> None:
        for p in self.pops:
            # A/D, then phenotype assembly with gen-0 conventions
            A_raw, D_raw = self._compute_ad(p)
            p.var_a_gen0 = np.array([phenotype.var(A_raw[j]) for j in range(self.n_pheno)])
            p.var_d_gen0 = np.array([phenotype.var(D_raw[j]) for j in range(self.n_pheno)])
            p.prev_phen = np.zeros((self.n_pheno, p.state.n))
            p.prev_F = np.zeros((self.n_pheno, p.state.n))
            self._assemble_phenotypes(p, gen=0, A_raw=A_raw, D_raw=D_raw, plan=None)
        self._apply_gamma()
        for p in self.pops:
            self._mating_selection_values(p, gen=0)
        for p in self.pops:
            p.prev_phen = p.state.comp["P"].copy()
            p.prev_F = p.state.comp["F"].copy()
            self._save_info(p, 0)
            self._record_traj(p, 0)
            # adjust beta from gen-0 variances (`Simulation.cpp:648-658`)
            for j, ph in enumerate(p.phenos):
                var_P = phenotype.var(p.state.comp["P"][j])
                var_F = phenotype.var(p.state.comp["F"][j])
                if self.vt_type == 1:
                    ph.beta = float(np.sqrt(ph.vf / (2 * var_P))) if var_P > 0 else ph.beta
                elif self.vt_type == 2 and var_F > 0:
                    ph.beta = float(np.sqrt(ph.vf / (2 * var_F)))

    def _gather_resident_cv(self, seg_st, seg_hap, mut) -> jax.Array:
        """Rebuild the resident CV matrix from a ledger (checkpoint-resume
        fallback): one `_ad_all` gather pass per phenotype."""
        parts = []
        for j in range(self.n_pheno):
            _, _, c = _ad_all(
                seg_st, seg_hap, mut,
                self.cv_bp_dev[j], self.global_cv[j],
                self.eff_a[j], self.eff_d[j], self.pop_starts,
                jnp.asarray(False), jnp.asarray(seg_st.shape[1], jnp.int32),
            )
            parts.append(c)
        return jnp.concatenate(parts, axis=3)

    # ----------------------------------------------------------------- A / D
    def _compute_ad(self, p: PopRuntime, gen: int = -1):
        """(npheno, n) raw additive & dominance values (`Simulation.cpp:2624-2749`)."""
        st = p.state
        A = np.zeros((self.n_pheno, st.n))
        D = np.zeros((self.n_pheno, st.n))
        dump_cv = self.cfg.debug and gen == self.tot_gen
        for j in range(self.n_pheno):
            if sum(self.ncv_real[j]) == 0:
                continue
            dominance_on = jnp.asarray(p.phenos[j].vd != 0)
            if st.cv is not None:
                c = st.cv[..., j * self.ncv_pad : (j + 1) * self.ncv_pad]
                A_j, D_j = _ad_resident(
                    c,
                    self.eff_a[j][:, 0, :],
                    self.eff_d[j][:, 0, :],
                    dominance_on,
                    jnp.asarray(st.n, dtype=jnp.int32),
                )
            else:
                # biobank-n: slice the individuals axis so _ad_all's
                # per-chromosome gather temporaries ((chunk, 2, ncv) int32
                # stacks) stay bounded — the unchunked program OOMs at
                # n=1e6 even serialized (measured); the debug allele dump
                # needs the whole matrix, so it keeps one call
                CH = int(os.environ.get("GE_AD_CHUNK", "131072"))
                rows = st.seg_st.shape[1]
                if dump_cv or rows <= CH:
                    A_j, D_j, c = _ad_all(
                        st.seg_st,
                        st.seg_hap,
                        st.mut,
                        self.cv_bp_dev[j],
                        self.global_cv[j],
                        self.eff_a[j],
                        self.eff_d[j],
                        self.pop_starts,
                        dominance_on,
                        jnp.asarray(st.n, dtype=jnp.int32),
                        want_cv=dump_cv,
                    )
                else:
                    # pass 1: global allele counts (the per-generation
                    # frequency in ras_compute_AD is population-wide, so
                    # chunks cannot each use their own); pass 2: A/D per
                    # chunk against the global frequency
                    def chunk_args(lo, hi):
                        return (
                            st.seg_st[:, lo:hi],
                            st.seg_hap[:, lo:hi],
                            st.mut[:, lo:hi],
                            self.cv_bp_dev[j],
                            self.global_cv[j],
                            self.eff_a[j],
                            self.eff_d[j],
                            self.pop_starts,
                            dominance_on,
                            jnp.asarray(
                                max(0, min(st.n - lo, hi - lo)), jnp.int32
                            ),
                        )

                    spans = [
                        (lo, min(lo + CH, rows))
                        for lo in range(0, rows, CH)
                    ]
                    counts = None
                    for lo, hi in spans:
                        t = np.asarray(
                            _ad_all(*chunk_args(lo, hi), want_cv=False,
                                    counts_only=True)
                        )
                        counts = t if counts is None else counts + t
                    counts = jnp.asarray(counts)
                    A_parts, D_parts = [], []
                    for lo, hi in spans:
                        A_c, D_c, _ = _ad_all(
                            *chunk_args(lo, hi), want_cv=False,
                            counts=counts,
                            n_freq=jnp.asarray(st.n, jnp.int32),
                        )
                        A_parts.append(np.asarray(A_c))
                        D_parts.append(np.asarray(D_c))
                    A_j = np.concatenate(A_parts)
                    D_j = np.concatenate(D_parts)
                    c = None
            A[j] = np.asarray(A_j, dtype=np.float64)[: st.n]
            D[j] = np.asarray(D_j, dtype=np.float64)[: st.n]
            if dump_cv:
                # per-chromatid CV dump at the final generation
                # (`Simulation.cpp:2665-2683`; one file per chr, the
                # reference overwrites it per phenotype — so do we)
                for ic in range(len(self.chrs)):
                    k = self.ncv_real[j][ic]
                    if k == 0:
                        continue
                    path = (
                        f"{self.cfg.prefix}.pop{p.index + 1}.gen{gen}"
                        f".chr{self.chrs[ic]}.cvval"
                    )
                    cv = np.asarray(c[ic, : st.n, :, :k])  # (n, 2, ncv)
                    inter = np.empty(
                        (cv.shape[0], 2 * cv.shape[2]), dtype=cv.dtype
                    )
                    inter[:, 0::2] = cv[:, 0]
                    inter[:, 1::2] = cv[:, 1]
                    np.savetxt(path, inter, fmt="%d", delimiter=" ")
        return A, D

    # ------------------------------------------------------------ phenotypes
    def _assemble_phenotypes(self, p, gen, A_raw, D_raw, plan) -> None:
        """E/F/C/P assembly (`ras_scale_AD_compute_GEF`, `Simulation.cpp:3075-3206`)."""
        st = p.state
        n = st.n
        comp = {k: np.zeros((self.n_pheno, n)) for k in "ADGCEFP"}
        rng_e = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.E_NOISE, p.index)
        )
        rng_f = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.F_GEN0, p.index)
        )
        for j, ph in enumerate(p.phenos):
            e_std = rng_e.standard_normal(n)
            if gen == 0:
                par_eff = (
                    rng_f.normal(0.0, np.sqrt(ph.vf), size=n)
                    if ph.vf > 0
                    else np.zeros(n)
                )
                C = st.comp.get("C", None)
                C = C[j] if C is not None else self._gen0_common(p, j, n)
            else:
                src = self.prev_for_vt(p)[j]
                par_eff = ph.beta * (
                    src[plan.child_father] + src[plan.child_mother]
                )
                C = st.comp["C"][j]
            out = phenotype.scale_components(
                A_raw[j],
                D_raw[j],
                e_std,
                par_eff,
                C,
                ph.va,
                ph.vd,
                ph.ve,
                ph.vf,
                p.var_a_gen0[j],
                p.var_d_gen0[j],
            )
            for k in comp:
                comp[k][j] = out[k]
        st.comp = comp

    def _gen0_common(self, p: PopRuntime, j: int, n: int) -> np.ndarray:
        ph = p.phenos[j]
        if ph.vc <= 0:
            return np.zeros(n)
        rng_c = np.random.default_rng(
            np_seed(self.cfg.seed, 0, Stage.INIT_COMMON, p.index * 131 + j)
        )
        return rng_c.normal(0.0, np.sqrt(ph.vc), size=n)

    def prev_for_vt(self, p: PopRuntime) -> np.ndarray:
        return p.prev_phen if self.vt_type == 1 else p.prev_F

    def _mating_selection_values(self, p: PopRuntime, gen: int) -> None:
        st = p.state
        omega = np.array([ph.omega for ph in p.phenos])
        lam = np.array([ph.lambda_ for ph in p.phenos])
        mv, sv = phenotype.mating_selection_values(st.comp["P"], omega, lam)
        st.mv = mv
        if gen == 0:
            p.sv_mean_gen0 = float(np.mean(sv))
            p.sv_var_gen0 = phenotype.var(sv)
        z = sv - p.sv_mean_gen0
        if p.sv_var_gen0 > 0:
            z = z / np.sqrt(p.sv_var_gen0)
        st.sv = z
        sched = p.schedule
        if gen == 0:
            st.svf = np.ones(st.n)
        else:
            g = gen - 1
            st.svf = phenotype.selection_prob(
                z,
                gen,
                sched.selection_func[g],
                sched.selection_par1[g],
                sched.selection_par2[g],
            )

    def _apply_gamma(self) -> None:
        """Population-specific environmental offsets (`Simulation.cpp:3345-3381`)."""
        if self.n_pop < 2:
            return
        for j, g in enumerate(self.cfg.gamma):
            if g == 0:
                continue
            if self.mesh is not None:
                # cross-population variance moments as one device
                # reduction per pop (psum across shards under the mesh;
                # SURVEY §2.4 'gamma-effect all-reduce'); the NR scalar
                # iteration stays host-side on the 3 fetched scalars
                moments = [
                    self._device_moments(p.state.comp["P"][j])
                    for p in self.pops
                ]
            else:
                moments = [
                    phenotype.pop_moments(p.state.comp["P"][j])
                    for p in self.pops
                ]
            ah = phenotype.solve_gamma_offset_moments(moments, g)
            offs = phenotype.gamma_offsets(self.n_pop, ah)
            for i, p in enumerate(self.pops):
                p.state.comp["P"][j] += offs[i]

    def _device_moments(self, x: np.ndarray) -> tuple:
        """(n, sum, sumsq) computed on device with the vector sharded over
        the mesh's 'ind' axis — XLA inserts the cross-shard psum."""
        from jax.sharding import NamedSharding, PartitionSpec

        n = x.shape[0]
        n_pad = self._pad_n(n)
        xp = np.zeros(n_pad, dtype=np.float64)
        xp[:n] = x
        xd = jax.device_put(
            jnp.asarray(xp, dtype=jnp.float32),
            NamedSharding(self.mesh, PartitionSpec("ind")),
        )
        s, ss = _moments_jit(xd)
        return float(n), float(s), float(ss)

    def _device_mate(
        self, p: PopRuntime, gen: int, pop_size: int, g: int
    ) -> "mating.MatingPlan":
        """Assortative pairing as one XLA program (`--device_mating`):
        the sorts/rank-match/veto run device-side (collectives under a
        sharded mesh, SURVEY §2.4 mate-pairing row); the result lands in the
        same MatingPlan the reproduce path consumes. Same law as the host
        oracle, different (jax) random stream."""
        from geneevolve_tpu.parallel import mating_device as md

        st = p.state
        key = stage_key(self.key, gen, Stage.MATE, p.index)
        law = p.schedule.offspring_dist[g]
        if law in ("f", "F") or self.exact_n:
            n_emit = realized = pop_size
        else:
            # realized generation size ~ Poisson(pop_size)
            # (`Simulation.cpp:2329-2337`); the device program emits a
            # static padded child count and the realized total is sliced
            # off the front (categorical draws are prefix-stable)
            rng_n = np.random.default_rng(
                np_seed(self.cfg.seed, gen, Stage.MATE, p.index)
            )
            n_emit = pop_size + 4 * int(np.sqrt(pop_size)) + 16
            drawn = max(1, int(rng_n.poisson(pop_size)))
            realized = min(drawn, n_emit)
            if drawn > n_emit:
                # ~3e-5/gen upper-tail truncation vs the host path's
                # unclamped law — rare, but make it observable
                self._log(
                    f"      warning: realized generation size {drawn} "
                    f"clamped to device-mating emit capacity {n_emit}"
                )
        plan = md.assort_mate_device(
            key,
            jnp.asarray(st.mv, dtype=jnp.float32),
            jnp.asarray(st.svf, dtype=jnp.float32),
            jnp.asarray(st.sex),
            {k: jnp.asarray(v) for k, v in st.ped.items()},
            float(p.schedule.mat_cor[g]),
            self.cfg.avoid_inbreeding,
            pop_size,
            mm_percent=p.mm_percent,
            offspring_dist=law,
            n_children=n_emit,
        )
        nc = int(plan.n_couples)
        if nc == 0:
            raise SimulationError("device mating produced zero couples")
        return mating.MatingPlan(
            father_pos=np.asarray(plan.father_pos)[:nc],
            mother_pos=np.asarray(plan.mother_pos)[:nc],
            inbred=np.asarray(plan.inbred)[:nc],
            child_couple=np.asarray(plan.child_couple)[:realized],
        )

    # ------------------------------------------------------------------ step
    def step(self, gen: int) -> None:
        t_gen = time.time()
        g = gen - 1  # schedule row
        for p in self.pops:
            st = p.state
            sched = p.schedule
            pop_size = int(sched.pop_size[g])
            rng_mate = np.random.default_rng(
                np_seed(self.cfg.seed, gen, Stage.MATE, p.index)
            )
            with self.timer("mate"):
                if self.cfg.device_mating and not p.rm:
                    plan = self._device_mate(p, gen, pop_size, g)
                elif p.rm:
                    plan = mating.random_mate(
                        rng_mate, st.svf, st.sex, pop_size
                    )
                else:
                    plan = mating.assort_mate(
                        rng_mate,
                        st.mv,
                        st.svf,
                        st.sex,
                        st.ped,
                        float(sched.mat_cor[g]),
                        p.mm_percent,
                        self.cfg.avoid_inbreeding,
                        sched.offspring_dist[g],
                        pop_size,
                        exact_n=self.exact_n,
                    )
            self._log(
                f"      pop {p.index + 1} gen {gen}: couples={plan.n_couples} "
                f"couple_cor_mv={plan.couple_cor_mating_value(st.mv):.3f}"
            )
            with self.timer("reproduce"):
                p.state = self._reproduce(p, gen, plan)
                if self.cfg.stage_sync:
                    jax.block_until_ready(
                        (p.state.seg_st, p.state.seg_hap, p.state.mut,
                         p.state.cv)
                    )
            with self.timer("compute_ad"):
                A_raw, D_raw = self._compute_ad(p, gen)
                if self.cfg.stage_sync:
                    jax.block_until_ready((A_raw, D_raw))
            with self.timer("phenotypes"):
                self._assemble_phenotypes(p, gen, A_raw, D_raw, plan)
        with self.timer("gamma_mv_sv"):
            self._apply_gamma()
            for p in self.pops:
                self._mating_selection_values(p, gen)
        if self.n_pop > 1:
            with self.timer("migration"):
                self._migrate(gen)
                if self.cfg.stage_sync:
                    jax.block_until_ready(
                        [(q.state.seg_st, q.state.mut) for q in self.pops]
                    )
        with self.timer("info_files"):
            for p in self.pops:
                p.prev_phen = p.state.comp["P"].copy()
                p.prev_F = p.state.comp["F"].copy()
                self._save_info(p, gen)
                self._record_traj(p, gen)
        if gen in self.out_gens:
            with self.timer("genotype_output"):
                self.save_genotypes(gen)
        # memory + timing report per generation (`Simulation.cpp:2067-2079`)
        vm, rss = telemetry.process_mem_usage()
        self._log("      -------------------------")
        self._log(f"      memory used: VM = {vm:.0f} Mb, RSS = {rss:.0f} Mb")
        for dev, mb in telemetry.device_memory_mb().items():
            self._log(f"        {dev}: HBM in use = {mb:.0f} Mb")
        self._log(
            f"      time used for this generation: "
            f"{time.time() - t_gen:.2f} seconds"
        )

    def _reproduce(self, p: PopRuntime, gen: int, plan: mating.MatingPlan) -> PopState:
        st = p.state
        # deferred guard from the PREVIOUS generation's real pass: checked
        # here (a point that syncs anyway) so the extra fetch costs nothing
        self._check_capacity_guard()
        n_child = len(plan.child_father)
        n_pad = self._child_rows(p, gen, n_child, st.seg_st.shape[1])
        # pad parent indices with 0: pad children are real meioses of
        # parent 0, never read (RNG draws are prefix-stable in the leading
        # axis, so real children's draws are unchanged by padding)
        father = jnp.asarray(
            np.pad(plan.child_father, (0, n_pad - n_child)), dtype=jnp.int32
        )
        mother = jnp.asarray(
            np.pad(plan.child_mother, (0, n_pad - n_child)), dtype=jnp.int32
        )
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            sh = NamedSharding(self.mesh, PartitionSpec("ind"))
            father = jax.device_put(father, sh)
            mother = jax.device_put(mother, sh)
        sm = p.smaps
        key = stage_key(self.key, gen, Stage.CROSSOVER, p.index)
        # plan residency mode: stacked plans (plan-once, default) keep the
        # whole (nchr, n, cap) plan alive between probe and real pass;
        # at biobank n those buffers are the peak-HBM driver, so past
        # GE_PLAN_BYTES_MAX (1.5 GB, a bound sized for a 16 GiB card and
        # not retuned for larger ones) the plan is re-drawn per chromosome group
        # just-in-time (draw-for-draw identical — shared _chr_plan_draws
        # key schedule, cross-checked by the capacity guard each gen)
        nchr_ = st.seg_st.shape[0]
        plan_bytes = 2 * nchr_ * n_pad * (self.xo_cap + self.mn_cap + 2) * 4
        per_group = (
            plan_bytes > int(os.environ.get("GE_PLAN_BYTES_MAX", "1500000000"))
            or os.environ.get("GE_PLAN_PER_GROUP") == "1"
        ) and os.environ.get("GE_PLAN_PER_GROUP") != "0"
        # plan pre-pass: samples every draw of the generation ONCE and
        # returns exact capacity needs; growth happens while the old state
        # is alive — the real pass donates the genome buffers, so an
        # after-the-fact redo is impossible
        with self.timer("reproduce/probe"):
            seg_need, mut_need, plan_arrays = _capacity_probe(
                st.seg_st,
                st.mut,
                father,
                mother,
                key,
                sm.bp,
                sm.xo_cum,
                sm.xo_lambda,
                sm.bin_width,
                sm.mut_bp,
                sm.mut_cum,
                sm.mut_lambda,
                self.xo_cap,
                self.mn_cap,
                self.has_mut,
                sm.xo_grid,
                sm.mut_grid,
                sm.bp0,
                sm.mut_bp0,
                sm.bp_step,
                sm.mut_bp_step,
                sm.xo_grid_w,
                sm.mut_grid_w,
                emit_plan=not per_group,
            )
            # one host sync per generation (the probe fetch)
            seg_need, mut_need = int(seg_need), int(mut_need)
        if seg_need > self.s_cap:
            self.s_cap = seg_need * 3 // 2 + 8
            a, b = _pad_ledger(st.seg_st, st.seg_hap, self.s_cap)
            st.seg_st, st.seg_hap = self._put(a), self._put(b)
            self._log(f"      [capacity grow] S={self.s_cap}")
        if mut_need > self.m_cap:
            self.m_cap = mut_need * 3 // 2 + 8
            st.mut = self._put(_pad_positions(st.mut, self.m_cap))
            self._log(f"      [capacity grow] M={self.m_cap}")
        t_real0 = time.perf_counter()
        if plan_arrays is not None:
            xo_f, xo_m, sh_plan, new_f, new_m = plan_arrays
        else:
            xo_f = xo_m = sh_plan = new_f = new_m = None
        statics = dict(
            s_cap=self.s_cap,
            m_cap=self.m_cap,
            merge_ibd=self.merge_ibd,
            has_mut=self.has_mut,
        )
        if (
            n_pad == st.seg_st.shape[1]
            and os.environ.get("GE_NO_INPLACE_REPRO") != "1"
        ):
            # constant population size: chain grouped in-place programs
            # (donated planes; peak HBM ~1x state — see
            # _reproduce_group_inplace). Results are bit-identical to the
            # batched path (each chromosome consumes its own plan rows).
            nchr = st.seg_st.shape[0]
            gn = min(nchr, int(os.environ.get("GE_INPLACE_GROUP", "2")))
            seg_st, seg_hap, mut, cv = st.seg_st, st.seg_hap, st.mut, st.cv
            seg_used = mut_used = None
            for c0 in range(0, nchr, gn):
                g = min(gn, nchr - c0)
                if per_group:
                    pg = _plan_group(
                        key, jnp.asarray(c0, dtype=jnp.int32), n_pad, g,
                        sm.bp, sm.xo_cum, sm.xo_lambda, sm.bin_width,
                        sm.mut_bp, sm.mut_cum, sm.mut_lambda,
                        self.xo_cap, self.mn_cap, self.has_mut,
                        sm.xo_grid, sm.mut_grid, sm.bp0, sm.mut_bp0,
                        sm.bp_step, sm.mut_bp_step,
                        sm.xo_grid_w, sm.mut_grid_w,
                    )
                else:
                    pg = (xo_f, xo_m, sh_plan, new_f, new_m)
                seg_st, seg_hap, mut, cv, su, mu_u = _reproduce_group_inplace(
                    seg_st, seg_hap, mut,
                    father, mother,
                    *pg,
                    jnp.asarray(c0, dtype=jnp.int32), gn=g,
                    cv=cv, cv_bp=self.cv_bp_all,
                    plan_local=per_group, **statics,
                )
                seg_used = su if seg_used is None else jnp.maximum(seg_used, su)
                mut_used = mu_u if mut_used is None else jnp.maximum(mut_used, mu_u)
        else:
            if per_group:
                # resize generations are rare; draw the full plan here
                xo_f, xo_m, sh_plan, new_f, new_m = _plan_group(
                    key, jnp.asarray(0, dtype=jnp.int32), n_pad,
                    st.seg_st.shape[0],
                    sm.bp, sm.xo_cum, sm.xo_lambda, sm.bin_width,
                    sm.mut_bp, sm.mut_cum, sm.mut_lambda,
                    self.xo_cap, self.mn_cap, self.has_mut,
                    sm.xo_grid, sm.mut_grid, sm.bp0, sm.mut_bp0,
                    sm.bp_step, sm.mut_bp_step,
                    sm.xo_grid_w, sm.mut_grid_w,
                )
            seg_st, seg_hap, mut, cv, seg_used, mut_used = _reproduce_all(
                st.seg_st,
                st.seg_hap,
                st.mut,
                father,
                mother,
                xo_f, xo_m, sh_plan, new_f, new_m,
                cv=st.cv,
                cv_bp=self.cv_bp_all,
                **statics,
            )
        st.seg_st = st.seg_hap = st.mut = st.cv = None  # donated
        if self.cfg.stage_sync:
            jax.block_until_ready((seg_st, seg_hap, mut, cv))
        dt = time.perf_counter() - t_real0
        self.timer.totals["reproduce/real"] = (
            self.timer.totals.get("reproduce/real", 0.0) + dt
        )
        self.timer.counts["reproduce/real"] = (
            self.timer.counts.get("reproduce/real", 0) + 1
        )
        # capacity correctness rests on _capacity_probe (a separately
        # compiled program) reproducing the real pass's draws bit-for-bit;
        # keep the real pass's own counts as a drift tripwire, fetched
        # lazily at the next sync (no extra host round-trip now)
        self._pending_used.append(
            (seg_used, mut_used, self.s_cap, self.m_cap, gen, p.index)
        )
        return PopState(
            seg_st=self._put(seg_st),
            seg_hap=self._put(seg_hap),
            mut=self._put(mut),
            cv=self._put(cv) if self.resident_cv else None,
            **self._child_host_fields(p, gen, plan),
        )

    def _child_host_fields(self, p: PopRuntime, gen: int,
                           plan: mating.MatingPlan) -> dict:
        """Children's sex/ids/pedigree/common-sibling effect
        (`Simulation.cpp:2416-2484`) — shared by every genome backend."""
        st = p.state
        n_child = len(plan.child_father)
        rng_sex = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.SEX, p.index)
        )
        rng_c = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.COMMON, p.index)
        )
        ids = np.arange(n_child, dtype=np.int64)
        fpos = plan.child_father
        mpos = plan.child_mother
        ped = {
            "father": st.ids[fpos],
            "mother": st.ids[mpos],
            "ff": st.ped["father"][fpos],
            "fm": st.ped["mother"][fpos],
            "mf": st.ped["father"][mpos],
            "mm": st.ped["mother"][mpos],
        }
        # common sibling effect shared within couples (`Simulation.cpp:2416-2429`)
        C = np.zeros((self.n_pheno, n_child))
        for j, ph in enumerate(p.phenos):
            if ph.vc > 0:
                per_couple = rng_c.normal(
                    0.0, np.sqrt(ph.vc), size=plan.n_couples
                )
                C[j] = per_couple[plan.child_couple]
        return dict(
            n=n_child,
            sex=rng_sex.integers(1, 3, size=n_child).astype(np.int8),
            ids=ids,
            ped=ped,
            comp={"C": C},
            mv=np.zeros(n_child),
            sv=np.zeros(n_child),
            svf=np.ones(n_child),
        )

    # -------------------------------------------------------------- migration
    def _migrate(self, gen: int) -> None:
        """Physical moves between populations (`Simulation.cpp:877-989`).

        Division of labor (SURVEY §2.4 'migration collective'):

        - Emigrant INDEX sampling is host-side and deliberately so: the
          draw uses the mesh-independent np_seed(seed, gen, MIGRATION)
          stream, so the selected rows are identical under any sharding
          (bit-identity tested 1-vs-8 devices,
          `tests/test_multipop.py::test_two_pop_migration_sharded_bit_identical`),
          and the work is O(round(m*n)) integers per generation — ~1e7
          index draws (~0.1 s numpy) even at pod-scale n=1e9 with m=1%,
          amortized against a full generation of device compute. Putting
          the sampler on device would buy nothing: the indices are
          consumed by host-orchestrated gathers either way.
        - The DATA movement is device-side: `_gather_state` gathers the
          surviving + immigrant rows directly between the pops' sharded
          ledger planes (no host round-trip of genome data).
        - The collective FORM at scale: when populations are partitioned
          across devices (deme mode), the same exchange is ONE
          all_to_all / ring ppermute over the mesh
          (`parallel/mesh.py:259-290`, dryrun-verified on 8 devices) —
          that is the pod-scale path; this method is the single-mesh
          form where every pop is resident on the same devices and a
          collective between them would be an artificial self-send.
        """
        mats = self.migration[gen - 1]
        rng_m = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.MIGRATION, 0)
        )
        sizes = [p.state.n for p in self.pops]
        leaving = []  # per source pop: (all_idx_sorted_desc, dest slices)
        for i, p in enumerate(self.pops):
            counts = [
                0 if i == j else int(round(mats[i, j] * sizes[i]))
                for j in range(self.n_pop)
            ]
            total = sum(counts)
            sample = rng_m.choice(sizes[i], size=total, replace=False)
            dests = np.repeat(
                [j for j in range(self.n_pop) if j != i],
                [counts[j] for j in range(self.n_pop) if j != i],
            )
            leaving.append((sample, dests))
        # build new states
        new_states = []
        for j, pj in enumerate(self.pops):
            keep = np.setdiff1d(
                np.arange(sizes[j]), leaving[j][0], assume_unique=False
            )
            parts = [(self.pops[j], keep)]
            for i, pi in enumerate(self.pops):
                if i == j:
                    continue
                idx = leaving[i][0][leaving[i][1] == j]
                if len(idx):
                    parts.append((pi, idx))
            new_states.append(self._gather_state(parts))
        for p, s in zip(self.pops, new_states):
            p.state = s
            self._log(
                f"      pop {p.index + 1} size after migration = {s.n}"
            )

    def _gather_state(self, parts) -> PopState:
        """Concatenate selected rows of several populations' states."""
        st_parts, hap_parts, mut_parts = [], [], []
        for src, idx in parts:
            idx_j = jnp.asarray(idx, dtype=jnp.int32)
            a, b = _pad_ledger(
                src.state.seg_st[:, idx_j], src.state.seg_hap[:, idx_j],
                self.s_cap,
            )
            st_parts.append(a)
            hap_parts.append(b)
            mut_parts.append(
                _pad_positions(src.state.mut[:, idx_j], self.m_cap)
            )
        seg_st = self._put(jnp.concatenate(st_parts, axis=1))
        seg_hap = self._put(jnp.concatenate(hap_parts, axis=1))
        mut = self._put(jnp.concatenate(mut_parts, axis=1))
        return PopState(
            seg_st=seg_st,
            seg_hap=seg_hap,
            mut=mut,
            **self._gather_host_fields(parts),
        )

    # ------------------------------------------------------------ checkpoint
    def _ckpt_genome_arrays(self, st: PopState) -> dict:
        """Backend hook: genome arrays to checkpoint (padding rows sliced
        off — checkpoints are mesh- and jitter-capacity-independent)."""
        d = {
            "seg_st": np.asarray(st.seg_st[:, : st.n]),
            "seg_hap": np.asarray(st.seg_hap[:, : st.n]),
            "mut": np.asarray(st.mut[:, : st.n]),
        }
        if st.cv is not None:
            d["cv"] = np.asarray(st.cv[:, : st.n])
        return d

    def _ckpt_make_state(self, z, pre: str, host: dict) -> PopState:
        """Backend hook: rebuild a population state from checkpoint arrays
        + shared host fields."""
        seg_st = self._put(jnp.asarray(z[f"{pre}.seg_st"]))
        seg_hap = self._put(jnp.asarray(z[f"{pre}.seg_hap"]))
        mut = self._put(jnp.asarray(z[f"{pre}.mut"]))
        cv = None
        if self.resident_cv:
            if f"{pre}.cv" in z.files:
                cv = self._put(jnp.asarray(z[f"{pre}.cv"]))
            else:  # older checkpoint: rebuild from the ledger
                cv = self._put(
                    self._gather_resident_cv(seg_st, seg_hap, mut)
                )
        return PopState(
            seg_st=seg_st, seg_hap=seg_hap, mut=mut, cv=cv, **host
        )

    def _gather_host_fields(self, parts) -> dict:
        """Concatenated host-side fields of selected rows across states —
        shared by every genome backend's migration gather."""

        def cat(get):
            return np.concatenate(
                [get(src.state)[..., idx] for src, idx in parts], axis=-1
            )

        ped = {
            k: np.concatenate([src.state.ped[k][idx] for src, idx in parts])
            for k in parts[0][0].state.ped
        }
        comp = {
            k: cat(lambda s, k=k: s.comp[k]) for k in parts[0][0].state.comp
        }
        return dict(
            n=sum(len(idx) for _, idx in parts),
            sex=np.concatenate([src.state.sex[idx] for src, idx in parts]),
            ids=np.concatenate([src.state.ids[idx] for src, idx in parts]),
            ped=ped,
            comp=comp,
            mv=cat(lambda s: s.mv),
            sv=cat(lambda s: s.sv),
            svf=cat(lambda s: s.svf),
        )

    # ------------------------------------------------------------- recording
    def _record_traj(self, p: PopRuntime, gen: int) -> None:
        st = p.state
        for j in range(self.n_pheno):
            for k in ("A", "D", "G", "C", "E", "F", "P"):
                p.traj[f"var_{k}"][j, gen] = phenotype.var(st.comp[k][j])
            vP = p.traj["var_P"][j, gen]
            p.traj["h2"][j, gen] = (
                p.traj["var_A"][j, gen] / vP if vP != 0 else np.nan
            )
        p.traj["var_mv"][gen] = phenotype.var(st.mv)
        p.traj["var_sv"][gen] = phenotype.var(st.sv)

    def show_results(self) -> None:
        """End-of-run console table of the per-generation variance
        components (`ras_show_res`, `Simulation.cpp:704-780`): first 40
        generations, fixed 3 decimals, reference row labels."""
        n_print = 40
        for p in self.pops:
            self._log(f" ---------- Population {p.index + 1}")
            G = p.traj["var_A"].shape[1]
            m = min(G, n_print)
            for j in range(self.n_pheno):
                self._log(f" phenotype: {j + 1}")
                rows = [
                    ("   var_A:", p.traj["var_A"][j, :m]),
                    ("   var_D:", p.traj["var_D"][j, :m]),
                    ("   var_G:", p.traj["var_G"][j, :m]),
                    ("   var_C:", p.traj["var_C"][j]),  # full (`:735`)
                    ("   var_E:", p.traj["var_E"][j, :m]),
                    ("   var_F:", p.traj["var_F"][j, :m]),
                    ("   var_P:", p.traj["var_P"][j, :m]),
                    ("   h2   :", p.traj["h2"][j, :m]),
                ]
                for label, vals in rows:
                    self._log(
                        label + "".join(f" {v:.3f}" for v in vals)
                    )
            self._log(
                " var_mating_value   :"
                + "".join(f" {v:.3f}" for v in p.traj["var_mv"][:m])
            )
            self._log(
                " var_selection_value:"
                + "".join(f" {v:.3f}" for v in p.traj["var_sv"][:m])
            )

    def _drain_io(self) -> None:
        """Wait for queued info-file writes; re-raise any writer error."""
        futures, self._io_futures = self._io_futures, []
        for f in futures:
            f.result()

    def _save_info(self, p: PopRuntime, gen: int) -> None:
        """Per-individual info file, queued on a background writer thread:
        the text formatting of n rows (~1.3 s at n=300k) overlaps the next
        generation's device work. The arrays snapshot by reference — each
        generation builds fresh PopState arrays, so the previous
        generation's are immutable once queued. `_drain_io` joins before
        anything that must observe the files (summary, genotype outputs,
        run end)."""
        st = p.state
        done = [f for f in self._io_futures if f.done()]
        self._io_futures = [f for f in self._io_futures if not f.done()]
        for f in done:
            f.result()  # surface writer errors (disk full, bad path) promptly
        self._io_futures.append(
            self._io_pool.submit(self._save_info_sync, p, st, gen)
        )

    def _save_info_sync(self, p: PopRuntime, st: PopState, gen: int) -> None:
        """Schema per `Population::ras_save_human_info`
        (`Population.cpp:510-568`)."""
        path = f"{self.cfg.prefix}.info.pop{p.index + 1}.gen{gen}.txt"
        cols = ["ID", "ID_Father", "ID_Mother", "ID_Fathers_Father",
                "ID_Fathers_Mother", "ID_Mothers_Father", "ID_Mothers_Mother",
                "sex"]
        for j in range(self.n_pheno):
            cols += [f"ph{j + 1}_{k}" for k in ("A", "D", "G", "C", "E", "F", "P")]
        cols += ["MV", "SV", "SV_f"]
        id_cols = [
            st.ids + 1,
            st.ped["father"] + 1,
            st.ped["mother"] + 1,
            st.ped["ff"] + 1,
            st.ped["fm"] + 1,
            st.ped["mf"] + 1,
            st.ped["mm"] + 1,
            st.sex,
        ]
        val_cols = []
        for j in range(self.n_pheno):
            for k in ("A", "D", "G", "C", "E", "F", "P"):
                val_cols.append(st.comp[k][j])
        val_cols += [st.mv, st.sv, st.svf]
        ids_arr = np.stack(id_cols, axis=1).astype(np.int64)
        vals_arr = np.stack(val_cols, axis=1).astype(np.float64)
        from geneevolve_tpu import native

        body = native.format_info(ids_arr, vals_arr)
        with open(path, "wb") as f:
            f.write((" ".join(cols) + "\n").encode())
            if body is not None:
                f.write(body)
            else:  # pure-Python fallback (GE_NO_NATIVE=1)
                for i in range(st.n):
                    f.write(
                        (
                            " ".join(str(x) for x in ids_arr[i])
                            + " "
                            + " ".join(f"{x:g}" for x in vals_arr[i])
                            + "\n"
                        ).encode()
                    )

    def write_summary(self) -> None:
        """`<prefix>.pop<i>.summary` (`Simulation.cpp:782-834`)."""
        self._drain_io()
        for p in self.pops:
            path = f"{self.cfg.prefix}.pop{p.index + 1}.summary"
            with open(path, "w") as f:
                cols = ["gen"]
                for j in range(self.n_pheno):
                    cols += [
                        f"ph{j + 1}_{k}"
                        for k in ("var_A", "var_D", "var_G", "var_C", "var_E",
                                  "var_F", "var_P", "h2", "var_G_std")
                    ]
                cols += ["var_mating_value", "var_selection_value"]
                f.write(" ".join(cols) + "\n")
                for gen in range(self.tot_gen + 1):
                    row = [str(gen)]
                    for j in range(self.n_pheno):
                        for k in ("var_A", "var_D", "var_G", "var_C", "var_E",
                                  "var_F", "var_P", "h2"):
                            row.append(f"{p.traj[k][j, gen]:g}")
                        g0 = p.traj["var_G"][j, 0]
                        gstd = p.traj["var_G"][j, gen] / g0 if g0 else float("nan")
                        row.append(f"{gstd:g}")
                    row.append(f"{p.traj['var_mv'][gen]:g}")
                    row.append(f"{p.traj['var_sv'][gen]:g}")
                    f.write(" ".join(row) + "\n")

    # --------------------------------------------------------------- outputs
    def save_genotypes(self, gen: int) -> None:
        from geneevolve_tpu.core import output

        output.save_genotypes(self, gen)

    # ------------------------------------------------------------------- run
    def run(self) -> None:
        from geneevolve_tpu.core import checkpoint

        cfg = self.cfg
        start_gen = 1
        if cfg.resume:
            # _load() already built maps/effect tables; the checkpoint
            # restores state and every gen-0-frozen constant
            done = checkpoint.load(self, cfg.resume)
            start_gen = done + 1
            self._log(f"    Resumed from {cfg.resume} after generation {done}")
        else:
            self.init_generation0()
            if cfg.checkpoint_every:
                checkpoint.save(self, 0, f"{cfg.prefix}.ckpt.npz")
        with telemetry.profiler_trace(cfg.profile_dir):
            for gen in range(start_gen, self.tot_gen + 1):
                self._log(f"    Start generation {gen}")
                self.step(gen)
                if cfg.checkpoint_every and gen % cfg.checkpoint_every == 0:
                    checkpoint.save(self, gen, f"{cfg.prefix}.ckpt.npz")
        self._check_capacity_guard()  # last generation's deferred check
        self.timer.report(self._log)
        self.show_results()  # `ras_show_res` console table (`:704-780`)
        self.write_summary()
        if not self.out_gens and (
            self.cfg.out_hap
            or self.cfg.out_plink
            or self.cfg.out_plink01
            or self.cfg.out_vcf
            or self.cfg.out_interval
        ):
            self.save_genotypes(self.tot_gen)


def _pad_ledger(st, hap, cap):
    cur = st.shape[-1]
    if cur >= cap:
        return st[..., :cap], hap[..., :cap]
    pad = [(0, 0)] * (st.ndim - 1) + [(0, cap - cur)]
    return (
        jnp.pad(st, pad, constant_values=segments._big()),
        jnp.pad(hap, pad, constant_values=0),
    )


def _pad_positions(x, cap):
    cur = x.shape[-1]
    if cur >= cap:
        return x[..., :cap]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, cap - cur)]
    return jnp.pad(x, pad, constant_values=segments._big())
