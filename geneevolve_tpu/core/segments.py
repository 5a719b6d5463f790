"""Fixed-shape segment-ledger genome representation and vectorized meiosis.

A chromatid is a sorted, fixed-capacity boundary array: `seg_st[k]` is the
bp where segment k starts and `seg_hap[k]` the (global) founder haplotype it
copies from; padding slots hold `BIG`. Lookup of "which founder hap covers
bp q" is `seg_hap[searchsorted(seg_st, q, 'right') - 1]`.

This is the vectorized replacement for the reference's per-individual
`vector<part>` interval lists (`/root/reference/src/Population.h:20-51`) and
its sequential `recombine` walk (`/root/reference/src/Simulation.cpp:2903-2958`):
meiosis becomes a sorted merge of three boundary arrays (the two parent
chromatids' starts + the sampled crossover positions), fully vmapped over
children.

Crossover sampling follows `ras_sim_loc_rec`
(`/root/reference/src/Simulation.cpp:2973-2995`): per-bin mass
p_k = (cM_k - cM_{k-1})/100, a hit on bin k lands at `bp[k] + U[0, width)`.
We draw a Poisson(Σp) point count and place points by inverse-CDF over bin
masses — the Poisson-process limit of the reference's per-bin Bernoulli,
identical to O(p²) per bin.

Mutations follow `ras_add_mutation` (`Simulation.cpp:2497-2552`): per-bin
Bernoulli(rate) → Poisson(Σrate) points, position uniform (inclusive) in
[bp[i-1], bp[i]], assigned to a random chromatid of the newborn, carried as
positions that flip the painted allele; inherited mutations survive iff the
child actually copied the carrying region (`Simulation.cpp:2961-2970`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import os

import jax
import jax.numpy as jnp
import numpy as np

# padding sentinel for positions; larger than any bp, small enough to add to
BIG = jnp.int64(2**62) if jax.config.jax_enable_x64 else jnp.int32(2**30)


def _big() -> int:
    return int(2**62) if jax.config.jax_enable_x64 else int(2**30)


_POS_DTYPE = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32


def pos_dtype():
    return jnp.int64 if jax.config.jax_enable_x64 else jnp.int32


_GRID_T_MIN = 8192
_GRID_T_MAX = 1 << 17


def build_cdf_grid(cum: np.ndarray, force_t: int = 0, force_w: int = 0):
    """Host-side inverse-CDF acceleration table for `sample_point_process`.

    For a uniform grid of T cells over [0, total mass), cell t stores
    `base[t] = searchsorted(cum, t*total/T, 'right')` plus the W+1 next
    DISTINCT CDF values after `cum[base[t]-1]` and their run lengths (the
    number of equal `cum` entries at each distinct value), so a device
    probe is ONE vectorized row gather plus <=W in-register compares —
    replacing the log2(K) rounds of dependent per-element gathers that
    `jnp.searchsorted`'s binary search needs per probe. T doubles until
    every cell spans at most W_MAX distinct boundaries.

    Run-length deduplication is what bounds W on real maps: the shipped
    Recom.Map.b37 maps have megabase runs of zero-mass bins (equal cum
    values) that would otherwise inflate a cell's raw span past 250
    boundaries; `searchsorted(..., 'right')` can never land inside such a
    run, so only the distinct values matter. If even the deduplicated W
    exceeds W_MAX at the T cap the function returns (None, 0) — the caller
    must fall back to the exact searchsorted path (never a silent clamp,
    which would misplace samples by whole zero-mass runs).

    Returns (table (T, 2W+3) int32 — col 0 = base, cols 1..W+2 = distinct
    cum values bitcast to int32 (col 1+j = j'th distinct value after
    cum[base-1], padded with +inf; col 1 = cum[base-1] itself, 0.0 when
    base == 0), cols W+3..2W+2 = int32 run lengths aligned with cols
    2..W+1 — and W). The device math reproduces
    `min(searchsorted(cum, u, 'right'), K-1)` bit-exactly for u in
    [0, total)."""
    K = len(cum)
    cum = np.asarray(cum, dtype=np.float32)
    total = float(cum[-1])
    W_MAX = 13
    # run-length compress: strictly increasing distinct values. vals[r] is
    # run r's value, starts[r]/ends[r] its [start, end) index range;
    # searchsorted(cum, x, 'right') always lands on a run boundary.
    keep = np.empty(K, dtype=bool)
    if K:
        keep[0] = True
        keep[1:] = cum[1:] != cum[:-1]
    vals = cum[keep]
    starts = np.flatnonzero(keep)
    ends = np.concatenate([starts[1:], [K]]).astype(np.int64)
    lengths = (ends - starts).astype(np.int32)
    R = len(vals)
    T = force_t or _GRID_T_MIN
    while True:
        v = np.arange(T + 2, dtype=np.float64) * (total / T)
        # the device computes the cell index in f32, which can land one cell
        # off near a boundary: each cell's window therefore covers its
        # neighbors too
        base = np.searchsorted(
            cum, v[:T].astype(np.float32), side="right"
        )
        base = np.minimum(base, np.concatenate([[base[0]], base[:-1]]))
        hi = np.searchsorted(cum, v[2:].astype(np.float32), side="left")
        # distinct-value window: runs rb..rh-1 (base is a run end, hi a
        # run start, so runs never straddle the window edges)
        rb = np.searchsorted(ends, base, side="right")
        rh = np.searchsorted(starts, hi, side="left")
        W = int(np.max(rh - rb)) if K else 0
        if force_t or W <= W_MAX or T >= _GRID_T_MAX:
            break
        T *= 2
    if force_w:
        if W > force_w:
            raise ValueError(
                f"cdf grid W={W} exceeds forced W={force_w} at T={T}"
            )
        W = force_w
    elif W > W_MAX:
        return None, 0  # caller falls back to exact searchsorted
    else:
        W = max(W, 1)
    # dv[:, 0] = cum[base-1] (0.0 below the first bin); dv[:, 1+j] =
    # vals[rb+j] for j in 0..W (one past the compare window, so the probe
    # can read cum[bins] for the bin-mass computation)
    dv = np.full((T, W + 2), np.inf, dtype=np.float32)
    dv[:, 0] = np.where(base > 0, cum[np.maximum(base - 1, 0)], 0.0)
    ridx = rb[:, None] + np.arange(W + 1)[None, :]
    okr = ridx < R
    dv[:, 1:] = np.where(okr, vals[np.minimum(ridx, max(R - 1, 0))], np.inf)
    jump = np.where(
        okr[:, :W], lengths[np.minimum(ridx[:, :W], max(R - 1, 0))], 0
    ).astype(np.int32)
    table = np.concatenate(
        [base.astype(np.int32)[:, None], dv.view(np.int32), jump], axis=1
    )
    return table, W


@dataclass(frozen=True)
class ChromMaps:
    """Static per-chromosome map data. Host-side (numpy): only the stacked
    form (`StackedMaps`) goes to the device, in a handful of batched
    transfers instead of ~140 per-chromosome ones at 22 chromosomes."""

    chrom: int
    chr_start: int
    chr_end: int
    bin_width: int
    bp: np.ndarray  # (K,) bin anchors
    xo_cum: np.ndarray  # (K,) cumulative crossover bin mass
    xo_lambda: float  # total crossover mass (Morgans for this chr)
    # mutation map (empty arrays when absent)
    mut_bp: np.ndarray  # (Km,)
    mut_cum: np.ndarray  # (Km,) cumulative mutation bin mass
    mut_lambda: float
    # affine-anchor shortcuts (bp[k] == bp[0] + k*step exactly): lets the
    # sampler compute anchors arithmetically instead of gathering bp[bins]
    bp_affine: bool = False
    mut_bp_affine: bool = False

    @staticmethod
    def build(chrom, rmap, mmap=None) -> "ChromMaps":
        p = rmap.prob
        np_pos = np.int64 if jax.config.jax_enable_x64 else np.int32
        if mmap is not None:
            mrate = mmap.rate.copy()
            mrate[0] = 0.0  # loop starts at bin 1 (`Simulation.cpp:2509`)
            mut_bp = np.asarray(mmap.bp, dtype=np_pos)
            mut_cum = np.cumsum(mrate).astype(np.float32)
            mut_lambda = float(mrate.sum())
        else:
            mut_bp = np.zeros((2,), dtype=np_pos)
            mut_cum = np.zeros((2,), dtype=np.float32)
            mut_lambda = 0.0
        bp = np.asarray(rmap.bp, dtype=np_pos)
        xo_cum = np.cumsum(p).astype(np.float32)

        def affine(a, w):
            return bool(
                len(a) > 1
                and np.array_equal(a, a[0] + np.arange(len(a)) * w)
            )

        return ChromMaps(
            chrom=int(chrom),
            chr_start=int(rmap.bp[0]),
            chr_end=int(rmap.bp[-1]),
            bin_width=int(rmap.bin_width),
            bp=bp,
            xo_cum=xo_cum,
            xo_lambda=float(p.sum()),
            mut_bp=mut_bp,
            mut_cum=mut_cum,
            mut_lambda=mut_lambda,
            bp_affine=affine(bp, int(rmap.bin_width)),
            mut_bp_affine=(
                affine(mut_bp, mut_bp[1] - mut_bp[0])
                if mmap is not None and len(mut_bp) > 1
                else False
            ),
        )


@dataclass(frozen=True)
class StackedMaps:
    """All chromosomes' maps padded to common lengths and stacked on a
    leading chr axis, so one compiled kernel serves every chromosome.
    Padding bins repeat the last anchor with zero added mass (cumulative
    arrays padded with their final value), so they are never sampled."""

    bp: jax.Array  # (nchr, K)
    xo_cum: jax.Array  # (nchr, K)
    xo_lambda: jax.Array  # (nchr,) float32
    bin_width: jax.Array  # (nchr,) float32
    mut_bp: jax.Array  # (nchr, Km)
    mut_cum: jax.Array  # (nchr, Km)
    mut_lambda: jax.Array  # (nchr,) float32
    chr_start: jax.Array  # (nchr,)
    # inverse-CDF grids (build_cdf_grid), common T/W across chromosomes,
    # stored row-major: (nchr, T, 2W+3)
    xo_grid: jax.Array = None
    xo_grid_w: int = 0  # static
    mut_grid: jax.Array = None
    mut_grid_w: int = 0
    # affine anchors: bp[c, k] == bp[c, 0] + k*step[c] exactly, all chrs
    bp0: jax.Array = None  # (nchr,) — None when any chr is non-affine
    mut_bp0: jax.Array = None
    bp_step: jax.Array = None  # (nchr,) pos dtype
    mut_bp_step: jax.Array = None

    @staticmethod
    def build(maps) -> "StackedMaps":
        def stack(arrs, dtype):
            K = max(a.shape[0] for a in arrs)
            out = np.stack(
                [
                    np.concatenate(
                        [np.asarray(a), np.full(K - a.shape[0], np.asarray(a)[-1])]
                    )
                    if a.shape[0] < K
                    else np.asarray(a)
                    for a in arrs
                ]
            )
            return jnp.asarray(out, dtype=dtype)

        def grids(cums):
            """Stacked grids with one T and W for every chromosome.

            If ANY live chromosome cannot build a grid within the W cap
            (even after run-dedup), the grid is disabled for the whole
            stack — T/W must be common across chromosomes, and a clamped
            window would silently misplace samples (the searchsorted
            fallback in `sample_point_process` is exact)."""
            live = [c for c in cums if len(c) and float(c[-1]) > 0]
            if not live:
                return None, 0
            first = [build_cdf_grid(c) for c in live]
            if any(t is None for t, _ in first):
                return None, 0
            t_glob = max(t.shape[0] for t, _ in first)
            built = [
                build_cdf_grid(c, force_t=t_glob)
                if len(c) and float(c[-1]) > 0
                else (None, 0)
                for c in cums
            ]
            if any(
                t is None
                for (t, _), c in zip(built, cums)
                if len(c) and float(c[-1]) > 0
            ):
                return None, 0
            w_glob = max(w for _, w in built)
            built = [
                build_cdf_grid(c, force_t=t_glob, force_w=w_glob)
                if len(c) and float(c[-1]) > 0
                else (None, 0)
                for c in cums
            ]
            inf_bits = np.float32(np.inf).view(np.int32)
            tables = []
            for tab, w in built:
                full = np.full((t_glob, 2 * w_glob + 3), inf_bits, np.int32)
                full[:, 0] = 0
                full[:, 1] = 0  # dv[0] = 0.0f (mass below the first bin)
                full[:, w_glob + 3 :] = 0  # run lengths of padding = 0
                if tab is not None:
                    full[:] = tab  # force_w pads every table to w_glob
                # row-major (T, 2W+3): the device gathers table ROWS
                # (see sample_point_process)
                tables.append(full)
            return jnp.asarray(np.stack(tables)), w_glob

        xo_grid, xo_w = grids([m.xo_cum for m in maps])
        mut_grid, mut_w = grids([m.mut_cum for m in maps])

        return StackedMaps(
            bp=stack([m.bp for m in maps], pos_dtype()),
            xo_cum=stack([m.xo_cum for m in maps], jnp.float32),
            xo_lambda=jnp.asarray(
                [m.xo_lambda for m in maps], dtype=jnp.float32
            ),
            bin_width=jnp.asarray(
                [m.bin_width for m in maps], dtype=jnp.float32
            ),
            mut_bp=stack([m.mut_bp for m in maps], pos_dtype()),
            mut_cum=stack([m.mut_cum for m in maps], jnp.float32),
            mut_lambda=jnp.asarray(
                [m.mut_lambda for m in maps], dtype=jnp.float32
            ),
            chr_start=jnp.asarray(
                [m.chr_start for m in maps], dtype=pos_dtype()
            ),
            xo_grid=xo_grid,
            xo_grid_w=xo_w,
            mut_grid=mut_grid,
            mut_grid_w=mut_w,
            bp0=(
                jnp.asarray([m.bp[0] for m in maps], dtype=pos_dtype())
                if all(m.bp_affine for m in maps)
                else None
            ),
            mut_bp0=(
                jnp.asarray([m.mut_bp[0] for m in maps], dtype=pos_dtype())
                if all(m.mut_bp_affine for m in maps)
                else None
            ),
            bp_step=jnp.asarray(
                [m.bin_width for m in maps], dtype=pos_dtype()
            ),
            mut_bp_step=jnp.asarray(
                [
                    int(m.mut_bp[1] - m.mut_bp[0]) if len(m.mut_bp) > 1 else 1
                    for m in maps
                ],
                dtype=pos_dtype(),
            ),
        )


def init_gen0_ledger(
    n: int, chr_start: int, hap_offset: int, capacity: int
) -> Tuple[jax.Array, jax.Array]:
    """Founder i's chromatids point wholly at founder haps 2i / 2i+1
    (+ global offset), as in `ras_initial_human_gen0`
    (`Simulation.cpp:3024-3035`)."""
    st = jnp.full((n, 2, capacity), _big(), dtype=pos_dtype())
    st = st.at[:, :, 0].set(chr_start)
    hap = jnp.zeros((n, 2, capacity), dtype=jnp.int32)
    base = hap_offset + 2 * jnp.arange(n, dtype=jnp.int32)
    hap = hap.at[:, 0, 0].set(base)
    hap = hap.at[:, 1, 0].set(base + 1)
    return st, hap


def empty_mutations(n: int, capacity: int) -> jax.Array:
    return jnp.full((n, 2, capacity), _big(), dtype=pos_dtype())


def init_gen0_ledger_stacked(
    n: int, chr_starts: np.ndarray, hap_offset: int, capacity: int,
    hap_dtype=jnp.int32, rows: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """(nchr, rows, 2, S) stacked founder ledgers (see
    `init_gen0_ledger`); `rows` >= n pads with edge copies of founder n-1
    (valid hap indices, masked from statistics) built host-side, so no
    device-side padded copy of the full ledger is ever made.

    `hap_dtype` may be int16 when the total founder-hap count fits
    (H <= 32k): halves the hap-index plane at biobank n."""
    nchr = len(chr_starts)
    rows = max(rows, n)
    st = np.full((nchr, rows, 2, capacity), _big(), dtype=np.int64)
    st[:, :, :, 0] = np.asarray(chr_starts)[:, None, None]
    hap = np.zeros((nchr, rows, 2, capacity), dtype=np.int32)
    base = hap_offset + 2 * np.minimum(
        np.arange(rows, dtype=np.int32), n - 1
    )
    hap[:, :, 0, 0] = base[None, :]
    hap[:, :, 1, 0] = base[None, :] + 1
    return (
        jnp.asarray(st, dtype=pos_dtype()),
        jnp.asarray(hap, dtype=hap_dtype),
    )


def empty_mutations_stacked(nchr: int, n: int, capacity: int) -> jax.Array:
    return jnp.full((nchr, n, 2, capacity), _big(), dtype=pos_dtype())


def cdf_grid_bins(u: jax.Array, cum: jax.Array, grid: jax.Array,
                  grid_w: int) -> jax.Array:
    """`min(searchsorted(cum, u, 'right'), K-1)` for u in [0, cum[-1]),
    any shape, through the inverse-CDF grid of `build_cdf_grid`: one
    narrow ROW gather + <=W in-register compares per probe, counting run
    lengths so a probe lands exactly where searchsorted-right would even
    across runs of equal cum values. Large probe sets run in lax.map chunks
    of 2^20 so the gathered (chunk, 2W+3) rows stay a bounded temporary at
    biobank n (a bound sized for a 16 GiB card)."""
    K = cum.shape[0]
    T = grid.shape[0]
    t = jnp.clip(
        (u * (jnp.float32(T) / cum[-1])).astype(jnp.int32), 0, T - 1
    )

    def probe(tc, uc):
        rows = grid[tc]  # (chunk, 2W+3) int32 — the only gather
        base = rows[:, 0]
        dv = jax.lax.bitcast_convert_type(
            rows[:, 1 : grid_w + 3], jnp.float32
        )
        jump = rows[:, grid_w + 3 :]  # (chunk, W) run lengths
        le = (dv[:, 1 : grid_w + 1] <= uc[:, None]).astype(jnp.int32)
        cnt = jnp.sum(jump * le, axis=1)  # entries <= u after base
        cnt = jnp.minimum(cnt, (K - 1) - base)  # old min(bins, K-1)
        return base + cnt

    P = u.size
    CH = 1 << 20
    if P > CH:
        pad = (-P) % CH
        ft = jnp.pad(t.reshape(-1), (0, pad))
        fu = jnp.pad(u.reshape(-1), (0, pad))
        bins = jax.lax.map(
            lambda a: probe(*a),
            (ft.reshape(-1, CH), fu.reshape(-1, CH)),
        )
        return bins.reshape(-1)[:P].reshape(u.shape)
    return probe(t.reshape(-1), u.reshape(-1)).reshape(u.shape)


def sample_point_process(
    key: jax.Array,
    n: int,
    cap: int,
    cum: jax.Array,
    lam,
    bp: jax.Array,
    width,
    inclusive_bins: bool,
    grid: jax.Array = None,  # (T, 2W+3) int32 build_cdf_grid table (row-major)
    grid_w: int = 0,  # static W of the grid (0 = use searchsorted)
    bp0=None,  # affine anchor base (traced scalar) — with bp_step,
    bp_step=None,  # replaces the bp[bins] gather by arithmetic
) -> jax.Array:
    """(n, cap) positions padded with BIG, non-decreasing in bin index.

    Each row: Poisson(lam) points; bin j chosen with prob mass[j]; position
    an independent uniform within the bin (matching the reference's
    Bernoulli-per-bin + uniform-within-bin law, `Simulation.cpp:2973-2995`).
    `inclusive_bins=False` = crossover convention (`bp[j] + U[0,width)`);
    True = mutation convention (uniform over [bp[j-1], bp[j]] inclusive).

    Bin selection is sort-free: the row's points are the order statistics
    of `count` uniforms on [0, total mass), generated as normalized
    cumulative Exp(1) gaps (S_1..S_c)/S_{c+1} — the classic representation
    — pushed through the monotone inverse-CDF over bin masses. No sort is
    needed, and this function runs 3x per chromosome per generation. The
    within-bin offset is a FRESH uniform (not the order
    statistic's remainder, whose f32 cancellation quantized low-mass bins
    to ~300 bp steps), so two same-bin points may appear out of order
    within the row — every consumer (`_active_at_T`, `rank_compact_T`,
    `mutation_flip_mask`) is compare/count-based and order-independent.

    `lam` and `width` may be python scalars or traced jax scalars (so one
    compiled function serves every chromosome); lam == 0 yields all-padding
    rows (jax.random.poisson returns 0 for rate 0)."""
    if isinstance(lam, (int, float)) and lam <= 0.0:
        return jnp.full((n, cap), _big(), dtype=pos_dtype())
    # biobank-n: about six (n, cap) f32 temporaries are alive per sampler,
    # so very large row counts run in independent chunks with per-chunk
    # subkeys — same law, bounded temps. The threshold keeps every
    # reference-scale run (n <= 2^19) on the original single-pass draws;
    # it was sized for a 16 GiB card and is not retuned for larger ones.
    CHN = int(os.environ.get("GE_SAMPLER_CHUNK", str(1 << 18)))
    if n > (1 << 19):
        outs = []
        for ck, lo in enumerate(range(0, n, CHN)):
            hi = min(lo + CHN, n)
            outs.append(
                sample_point_process(
                    jax.random.fold_in(key, ck), hi - lo, cap, cum, lam,
                    bp, width, inclusive_bins, grid=grid, grid_w=grid_w,
                    bp0=bp0, bp_step=bp_step,
                )
            )
        return jnp.concatenate(outs, axis=0)
    K = cum.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    counts = jnp.minimum(jax.random.poisson(k1, lam, (n,)), cap)
    gaps = -jnp.log1p(-jax.random.uniform(k2, (n, cap + 1), dtype=jnp.float32))
    s = jnp.cumsum(gaps, axis=1)
    # S_{c+1} per row, via masked sum (per-row dynamic gathers are slow)
    denom = jnp.sum(
        jnp.where(jnp.arange(cap + 1)[None, :] == counts[:, None], s, 0.0),
        axis=1,
    )
    u = s[:, :cap] / jnp.maximum(denom, 1e-30)[:, None] * cum[-1]
    if grid is not None and grid_w > 0:
        bins = cdf_grid_bins(u, cum, grid, grid_w)
    else:
        bins = jnp.searchsorted(cum, u, side="right")
        bins = jnp.minimum(bins, K - 1)
    # fresh uniform for the within-bin offset: full f32 resolution at any
    # bin mass (the order statistic u only selects the bin)
    v = jnp.minimum(
        jax.random.uniform(k3, (n, cap), dtype=jnp.float32), 1.0 - 1e-7
    )
    if bp0 is not None:
        # affine anchors: bp[k] == bp0 + k*step exactly (checked at load)
        bp_bin = (bp0 + bins.astype(pos_dtype()) * bp_step).astype(
            pos_dtype()
        )
        bp_prev = bp_bin - bp_step
    else:
        bp_bin = bp[bins]
        bp_prev = bp[jnp.maximum(bins - 1, 0)]
    if inclusive_bins:
        span = (bp_bin - bp_prev + 1).astype(jnp.float32)
        pos = bp_prev + jnp.floor(v * span).astype(pos_dtype())
    else:
        w = jnp.asarray(width, dtype=jnp.float32)
        pos = bp_bin + jnp.floor(v * w).astype(pos_dtype())
    return jnp.where(
        jnp.arange(cap)[None, :] < counts[:, None], pos, _big()
    )


def _active_at_T(xo_T: jax.Array, start_hap: jax.Array, q_T: jax.Array) -> jax.Array:
    """Which parent chromatid the gamete copies at each query position.

    Transposed layout: `xo_T` is (K, nc) sorted crossover positions (BIG
    padded), `q_T` is (Q, nc), `start_hap` is (nc,). The crossover count
    #{xo <= q} is a broadcast compare-reduce that XLA fuses, with no
    data-dependent gathers. BIG padding slots never count: valid q < BIG < nothing, pad xo == BIG >
    every valid q."""
    cnt = jnp.sum(
        (xo_T[None, :, :] <= q_T[:, None, :]).astype(jnp.int32), axis=1
    )
    return (start_hap[None, :] + cnt) % 2


def _seg_lookup_T(pos_T: jax.Array, hap_T: jax.Array, q_T: jax.Array) -> jax.Array:
    """hap covering each query: `hap[#{pos <= q} - 1]`, transposed layout.

    `pos_T`/`hap_T` are (S, nc) sorted-boundary columns, `q_T` is (Q, nc).
    The covering-segment index is a compare-reduce and the hap fetch a
    one-hot select-reduce over the S axis — both data-parallel vector ops,
    no data-dependent gathers."""
    S = pos_T.shape[0]
    idx = (
        jnp.sum((pos_T[None, :, :] <= q_T[:, None, :]).astype(jnp.int32), axis=1)
        - 1
    )
    return jnp.sum(
        jnp.where(
            idx[:, None, :] == jnp.arange(S)[None, :, None],
            hap_T[None, :, :],
            0,
        ).astype(hap_T.dtype),
        axis=1,
    )


def rank_compact_T(cand, valid, cap, *vals):
    """Stable compaction-sort of (L, nc) columns without a sort HLO.

    Each valid element's output slot is its rank among valid elements by
    (value, candidate index); the first `cap` slots are materialized by
    one-hot select-reduces. Invalid elements are dropped; output positions
    past the per-column valid count read BIG (first returned array) / 0
    (the rest). Everything is broadcast compare/select-reduce — O(L^2) vector
    work that XLA fuses without materializing the (L, L, nc) intermediates.
    `jax.lax.sort` would be O(L log^2 L), but at these short columns the
    fused compare-reduce needs no sort, scatter or per-row gather.

    Returns (out_st, *out_vals, n_valid)."""
    L, nc = cand.shape
    vi = valid.astype(jnp.int32)
    # rank_i = #{valid j: (c_j, j) < (c_i, i)}; i on axis 0, j on axis 1
    lt = cand[None, :, :] < cand[:, None, :]
    tie = (cand[None, :, :] == cand[:, None, :]) & (
        jnp.arange(L)[None, :, None] < jnp.arange(L)[:, None, None]
    )
    rank = jnp.sum(
        ((lt | tie) & valid[None, :, :]).astype(jnp.int32), axis=1
    )
    n_valid = jnp.sum(vi, axis=0)
    slot = jnp.arange(cap)[:, None, None]  # (cap, 1, 1)
    hit = (rank[None, :, :] == slot) & valid[None, :, :]  # (cap, L, nc)
    pad = jnp.arange(cap)[:, None] >= n_valid[None, :]
    out_st = jnp.where(
        pad,
        _big(),
        jnp.sum(jnp.where(hit, cand[None, :, :], 0), axis=1),
    ).astype(cand.dtype)
    outs = [out_st]
    for v in vals:
        outs.append(
            jnp.where(
                pad, 0, jnp.sum(jnp.where(hit, v[None, :, :], 0), axis=1)
            ).astype(v.dtype)
        )
    return (*outs, n_valid)


def merge3_T(
    X: jax.Array,  # (Kx, nc) small candidate list (crossovers; NOT sorted)
    A: jax.Array,  # (S, nc) sorted-ascending valid prefix (BIG padded)
    B: jax.Array,  # (S, nc) sorted likewise
    vX: jax.Array,  # bool masks, same shapes
    vA: jax.Array,
    vB: jax.Array,
    hX: jax.Array,  # carried hap per candidate
    hA: jax.Array,
    hB: jax.Array,
    cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Stable 3-list merge by rank, exploiting that A and B are sorted.

    Produces exactly `rank_compact_T`'s output for the concatenated
    candidate list [X; A; B] (rank by (value, candidate index)), but the
    within-A and within-B ranks collapse to prefix-sums of the valid mask
    (their valid entries are ascending — the ledger invariant), so the
    pairwise compare work drops from (Kx+2S)^2 to Kx^2 + 2*Kx*S + S^2 per
    column — ~3x fewer at reference shapes, on the engine's hottest op.
    Tie rules follow candidate order X < A < B: an A element counts X
    elements with value <= its own, B elements with value strictly <."""
    big = _big()
    i32 = jnp.int32
    Kx = X.shape[0]
    S = A.shape[0]
    nc = X.shape[1]
    Xm = jnp.where(vX, X, big)
    Am = jnp.where(vA, A, big)
    Bm = jnp.where(vB, B, big)

    def cnt(P, Q, inclusive):
        # (Lq, nc): per Q element, #P elements < (or <=) it; BIG-masked
        # P never counts against a valid Q (valid < BIG)
        if inclusive:
            hit = P[None, :, :] <= Q[:, None, :]
        else:
            hit = P[None, :, :] < Q[:, None, :]
        return jnp.sum(hit.astype(i32), axis=1)

    # within-X: full (small) stable rank
    ltX = (Xm[None, :, :] < Xm[:, None, :]) | (
        (Xm[None, :, :] == Xm[:, None, :])
        & (jnp.arange(Kx)[None, :, None] < jnp.arange(Kx)[:, None, None])
    )
    ownX = jnp.sum((ltX & vX[None, :, :]).astype(i32), axis=1)
    vAi = vA.astype(i32)
    vBi = vB.astype(i32)
    prefA = jnp.cumsum(vAi, axis=0) - vAi
    prefB = jnp.cumsum(vBi, axis=0) - vBi
    rank_X = ownX + cnt(Am, Xm, False) + cnt(Bm, Xm, False)
    rank_A = prefA + cnt(Xm, Am, True) + cnt(Bm, Am, False)
    rank_B = prefB + cnt(Xm, Bm, True) + cnt(Am, Bm, True)
    n_valid = (
        jnp.sum(vX.astype(i32), axis=0)
        + jnp.sum(vAi, axis=0)
        + jnp.sum(vBi, axis=0)
    )
    slot = jnp.arange(cap)[:, None, None]  # (cap, 1, 1)
    st_acc = jnp.zeros((cap, nc), dtype=A.dtype)
    hap_acc = jnp.zeros((cap, nc), dtype=jnp.int32)
    for val, h, rank, v in (
        (Xm, hX, rank_X, vX),
        (Am, hA, rank_A, vA),
        (Bm, hB, rank_B, vB),
    ):
        hit = (rank[None, :, :] == slot) & v[None, :, :]
        st_acc = st_acc + jnp.sum(
            jnp.where(hit, val[None, :, :], 0), axis=1
        ).astype(A.dtype)
        hap_acc = hap_acc + jnp.sum(
            jnp.where(hit, h[None, :, :], 0), axis=1
        ).astype(jnp.int32)
    pad = jnp.arange(cap)[:, None] >= n_valid[None, :]
    out_st = jnp.where(pad, big, st_acc).astype(A.dtype)
    out_hap = jnp.where(pad, 0, hap_acc)
    return out_st, out_hap, n_valid


def meiose(
    par_st: jax.Array,  # (nc, 2, S) parent chromatid boundary starts
    par_hap: jax.Array,  # (nc, 2, S)
    xo: jax.Array,  # (nc, K) sorted crossover positions (BIG padded)
    start_hap: jax.Array,  # (nc,) 0/1
    capacity: int,
    merge_ibd: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One gamete per child, batched: returns (child_st (nc, capacity),
    child_hap, n_valid (nc,)).

    The child ledger is the merge of three sorted candidate lists — the
    chromosome start + crossover positions, and the two parent chromatids'
    boundaries (each kept iff the gamete copies that chromatid there) —
    realized as one rank-select compaction (`rank_compact_T`). Replaces the
    reference's sequential `recombine` part walk
    (`/root/reference/src/Simulation.cpp:2903-2958`).

    `merge_ibd=True` (the main-loop mode) leaves same-position /
    same-founder adjacent duplicates in place: every downstream consumer
    probes the ledger with a "last boundary <= q" rule, for which a
    duplicate run and its last element are indistinguishable, and the
    capacity model (Poisson(G*L) total inherited crossovers) already covers
    the un-merged count. `merge_ibd=False` reproduces the reference's exact
    part splitting — every crossover keeps its own boundary, zero-length
    parts removed (keep-last) — which the `.int` dump
    (`Simulation.cpp:1582-1639`) relies on to encode recombination history.
    """
    nc, _, S = par_st.shape
    K = xo.shape[1]
    big = _big()
    A = par_st[:, 0, :].T  # (S, nc)
    B = par_st[:, 1, :].T
    hA = par_hap[:, 0, :].T
    hB = par_hap[:, 1, :].T
    xo_T = xo.T  # (K, nc)
    chr_start = A[0]  # ledger invariant: first boundary = chr start
    X = jnp.concatenate([chr_start[None], xo_T], axis=0)  # (K+1, nc)
    actX = _active_at_T(xo_T, start_hap, X)
    actA = _active_at_T(xo_T, start_hap, A)
    actB = _active_at_T(xo_T, start_hap, B)
    # parents' row 0 is always chr_start (ledger invariant) and X row 0
    # supplies that boundary with the identical covering hap — keeping both
    # would accumulate one duplicate slot per generation, so the parents'
    # copies are dropped unconditionally
    not_first = jnp.arange(S)[:, None] > 0
    vX = jnp.concatenate(
        [jnp.ones((1, nc), dtype=bool), xo_T < big], axis=0
    )
    vA = (A < big) & (actA == 0) & not_first
    vB = (B < big) & (actB == 1) & not_first
    # hap per candidate: crossover rows look up the covering segment of the
    # newly-active chromatid; parent-boundary rows carry their own hap (a
    # position-duplicate within one chromatid always travels with its twin,
    # so own-hap vs last-duplicate-hap is probe-equivalent)
    hX = jnp.where(
        actX == 0, _seg_lookup_T(A, hA, X), _seg_lookup_T(B, hB, X)
    )
    st, hap, n_valid = merge3_T(
        X, A, B, vX, vA, vB,
        hX.astype(jnp.int32), hA.astype(jnp.int32), hB.astype(jnp.int32),
        capacity,
    )
    if not merge_ibd:
        # exact part splitting: drop earlier entries of equal positions
        # (zero-length parts the reference never emits), keep the last
        last = jnp.concatenate(
            [(st[1:] != st[:-1]) | (st[1:] >= big), jnp.ones((1, nc), bool)],
            axis=0,
        )
        keep = last & (st < big)
        st, hap, n_valid = rank_compact_T(
            jnp.where(keep, st, big), keep, capacity, hap
        )
    return (
        st.T,
        hap.T.astype(par_hap.dtype),
        n_valid,
    )


def count_merge_valid(
    par_st: jax.Array,  # (nc, 2, S)
    xo: jax.Array,  # (nc, K)
    start_hap: jax.Array,  # (nc,)
) -> jax.Array:
    """(nc,) exact valid-boundary count of `meiose`'s merge, without
    building it — the capacity pre-pass that lets the engine donate the
    genome buffers to the real pass (regrowth must be decided while the
    old state is still alive)."""
    nc, _, S = par_st.shape
    big = _big()
    A = par_st[:, 0, :].T
    B = par_st[:, 1, :].T
    xo_T = xo.T
    actA = _active_at_T(xo_T, start_hap, A)
    actB = _active_at_T(xo_T, start_hap, B)
    not_first = jnp.arange(S)[:, None] > 0
    return (
        1
        + jnp.sum((xo_T < big).astype(jnp.int32), axis=0)
        + jnp.sum(((A < big) & (actA == 0) & not_first).astype(jnp.int32), axis=0)
        + jnp.sum(((B < big) & (actB == 1) & not_first).astype(jnp.int32), axis=0)
    )


def inherit_mutations(
    par_mut: jax.Array,  # (nc, 2, M) parent chromatid mutation positions
    xo: jax.Array,  # (nc, K)
    start_hap: jax.Array,  # (nc,)
    new_mut: jax.Array,  # (nc, Mn) new mutations for this gamete (BIG padded)
    capacity: int,
) -> Tuple[jax.Array, jax.Array]:
    """Keep a parent mutation iff the gamete copied its region
    (`modify_part_for_mutation_pos`, `Simulation.cpp:2961-2970`), merge in
    the de novo ones, dedupe repeated positions (the reference flips on
    membership, not count). Batched, transposed-axis sorts."""
    nc = par_mut.shape[0]
    big = _big()
    m0 = par_mut[:, 0, :].T  # (M, nc)
    m1 = par_mut[:, 1, :].T
    xo_T = xo.T
    k0 = jnp.where(
        (m0 < big) & (_active_at_T(xo_T, start_hap, m0) == 0), m0, big
    )
    k1 = jnp.where(
        (m1 < big) & (_active_at_T(xo_T, start_hap, m1) == 1), m1, big
    )
    allm = jnp.concatenate([k0, k1, new_mut.T], axis=0)  # (Lm, nc)
    # dedupe before ranking: keep only the first of each repeated position
    # (the reference flips on membership, not count)
    Lm = allm.shape[0]
    first = ~jnp.any(
        (allm[None, :, :] == allm[:, None, :])
        & (jnp.arange(Lm)[None, :, None] < jnp.arange(Lm)[:, None, None])
        & (allm[:, None, :] < big),
        axis=1,
    )
    keep = first & (allm < big)
    allm, n_valid = rank_compact_T(
        jnp.where(keep, allm, big), keep, capacity
    )
    return allm.T, n_valid


def hap_at(seg_st: jax.Array, seg_hap: jax.Array, q: jax.Array) -> jax.Array:
    """Founder hap covering position(s) q: `hap[#{st <= q} - 1]`.

    seg_* are (..., S); q is (..., Q) with matching leading dims (or a
    broadcastable 1-D q). The covering index is a broadcast compare-reduce
    over the (bounded, ~50-slot) ledger axis and the hap fetch a one-hot
    select-reduce — O(Q*S) vector work that XLA fuses without materializing
    the (..., Q, S) intermediate, instead of a per-row searchsorted and
    dynamic gather."""
    lead = seg_st.shape[:-1]
    S = seg_st.shape[-1]
    if q.ndim == 1:
        q = jnp.broadcast_to(q, lead + q.shape)
    idx = (
        jnp.sum(
            (seg_st[..., None, :] <= q[..., :, None]).astype(jnp.int32),
            axis=-1,
        )
        - 1
    )
    return jnp.sum(
        jnp.where(
            idx[..., None] == jnp.arange(S),
            seg_hap[..., None, :],
            0,
        ).astype(seg_hap.dtype),
        axis=-1,
    )


def mutation_flip_mask(mut: jax.Array, q: jax.Array) -> jax.Array:
    """(..., Q) bool: is there a carried mutation exactly at q?
    Mutations only flip alleles at panel positions they coincide with
    (`Simulation.cpp:2770-2775`, `:1218-1222`).

    Membership is an any-equal broadcast reduce over the (small, BIG-padded)
    mutation axis — fused by XLA, no gathers."""
    lead = mut.shape[:-1]
    q = jnp.broadcast_to(q, lead + q.shape[-1:])
    hit = jnp.any(mut[..., None, :] == q[..., :, None], axis=-1)
    return hit & (q < _big())
