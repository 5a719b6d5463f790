"""Mesh construction and the sharded dense generation step."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from geneevolve_tpu.dense.step import DenseConfig, make_step


def _factor(n: int) -> tuple:
    """Split n devices into (ind, loci) favoring the individuals axis."""
    best = (n, 1)
    for loci in (1, 2, 4, 8):
        if n % loci == 0 and loci * loci <= n:
            best = (n // loci, loci)
    return best


def make_mesh(
    devices: Optional[Sequence] = None, shape: Optional[tuple] = None
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    shape = shape or _factor(n)
    assert shape[0] * shape[1] == n, (shape, n)
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, ("ind", "loci"))


def state_specs(packed: bool = True) -> dict:
    """PartitionSpecs for the engine state: individuals x loci block
    sharding on the haplotype planes, CV columns/effects replicated."""
    if packed:
        return {
            "hap": P("ind", None, "loci"),
            "cv": P("ind", None, None),
            "cv_idx": P(),
            "eff": P(),
            "clip": P(),
        }
    return {
        "hapA": P("ind", "loci"),
        "hapB": P("ind", "loci"),
        "cv_idx": P(),
        "eff": P(),
        "clip": P(),
    }


def shard_state(state: dict, mesh: Mesh) -> dict:
    specs = state_specs(packed="hap" in state)
    return {
        k: jax.device_put(v, NamedSharding(mesh, specs[k]))
        for k, v in state.items()
    }


def make_sharded_step(cfg, mesh: Mesh):
    """jit'd generation step with (ind, loci) shardings on the haplotype
    state. Parent-row gathers ride the 'ind' axis; the allele-frequency
    reduction in the phenotype path is a psum over 'ind'; crossover plans
    are replicated along 'loci'. Accepts a DenseConfig or PackedConfig (the
    packed engine shards identically: the loci axis just carries words).

    This is the *panmictic* (global random mating) mode: exact single-device
    semantics, but the cross-shard parent gather costs an all-gather of the
    parent planes along 'ind'. For linear weak scaling use
    `make_deme_step`."""
    from geneevolve_tpu.dense.packed import PackedConfig
    from geneevolve_tpu.dense.packed import make_step as make_packed_step

    packed = isinstance(cfg, PackedConfig)
    step = make_packed_step(cfg) if packed else make_step(cfg)
    specs = state_specs(packed)
    in_shardings = (
        {k: NamedSharding(mesh, v) for k, v in specs.items()},
        NamedSharding(mesh, P()),
    )
    out_shardings = {k: NamedSharding(mesh, v) for k, v in specs.items()}
    return jax.jit(step, in_shardings=in_shardings, out_shardings=out_shardings)


def make_deme_step(cfg, mesh: Mesh, mig_rate: float = 0.0,
                   mig_matrix=None):
    """Deme-mode sharded generation step (shard_map over the mesh).

    Each individuals-shard is a *deme*: children pick parents within their
    own shard, so meiosis needs zero cross-device traffic; chromosomes are
    split whole across loci shards, so crossover plans are per-shard
    independent. The only collectives are one small `psum` over 'loci' to
    assemble the selection phenotype from each shard's CV columns, and —
    with `mig_rate` > 0 — one `ppermute` over 'ind' that exchanges
    emigrants between neighboring demes in a ring.

    Migration maps the reference's `ras_do_migration`
    (`/root/reference/src/Simulation.cpp:877-989`: counts = round(m*n),
    sample emigrants without replacement, move them) onto the device
    interconnect: each generation, round(mig_rate * n_deme) children
    sampled without replacement (a loci-invariant permutation, so all loci
    shards move the same rows) are sent to the next deme and replaced by the previous
    deme's emigrants — a row-ragged all_to_all specialized to the ring.
    With island-model migration (N_deme * m >> 1) the metapopulation's
    heterozygosity trajectory matches panmictic Ne = n (validated in
    `tests/test_statistics.py`); with mig_rate=0 each deme drifts at
    Ne = n/ind_n. This is the linear-weak-scaling configuration; panmictic
    exact mode is `make_sharded_step`.

    `mig_matrix`: optional (D, D) row-stochastic matrix (D = number of
    demes) generalizing the ring — the reference's arbitrary migration
    matrix (`Simulation.cpp:877-989`: counts = round(m_ij * n_i), emigrants
    sampled without replacement) mapped onto fixed-size demes: deme i sends
    k_ij = round(m_ij * n_deme) children to deme j through ONE
    `all_to_all` over 'ind'; arrivals replace randomly chosen residents.
    Counts are static (compile-time), so the exchange is a fixed-shape
    (D, k_pad, ...) tensor transpose between devices — no host round
    trips.
    Unbalanced matrices (sum_i k_ij != sum_j k_ij) keep deme sizes fixed by
    construction; the reference's physically-moving semantics are recovered
    exactly when the matrix is balanced (every ring/island matrix is).

    Requires cfg.n % mesh_ind == 0 and cfg.n_chr % mesh_loci == 0."""
    from geneevolve_tpu.dense.packed import (
        PackedConfig,
        cv_child,
        make_reproduce,
        mutation_positions,
    )
    from geneevolve_tpu.dense.step import _sample_gamete_plan

    assert isinstance(cfg, PackedConfig)
    ind_n, loci_n = mesh.devices.shape
    assert cfg.n % ind_n == 0, (cfg.n, ind_n)
    assert cfg.n_chr % loci_n == 0, (cfg.n_chr, loci_n)
    cfg_loc = PackedConfig(
        n=cfg.n // ind_n,
        m=cfg.m // loci_n,
        n_chr=cfg.n_chr // loci_n,
        morgans_per_chr=cfg.morgans_per_chr,
        xo_cap=cfg.xo_cap,
        mut_rate=cfg.mut_rate / loci_n,  # genome rate split over loci shards
        mut_cap=cfg.mut_cap,
        ncv=cfg.ncv,
        selection=cfg.selection,
    )
    reproduce = make_reproduce(cfg_loc)
    dense_loc = cfg_loc.as_dense()
    n_loc, m_loc = cfg_loc.n, cfg_loc.m
    n_emig = int(round(mig_rate * n_loc)) if ind_n > 1 else 0
    if not 0 <= n_emig <= n_loc:
        raise ValueError(f"mig_rate {mig_rate} out of range")
    counts = None
    if mig_matrix is not None:
        if n_emig:
            raise ValueError("give either mig_rate or mig_matrix, not both")
        M = np.asarray(mig_matrix, dtype=np.float64)
        if M.shape != (ind_n, ind_n):
            raise ValueError(f"mig_matrix must be ({ind_n}, {ind_n})")
        if np.any(np.abs(M.sum(axis=1) - 1.0) > 1e-5):
            raise ValueError("mig_matrix rows must sum to 1")
        counts = np.round(M * n_loc).astype(np.int32)
        np.fill_diagonal(counts, 0)  # stayers are not exchanged
        if counts.sum(axis=1).max() > n_loc:
            raise ValueError("mig_matrix emigrates more than a whole deme")
        k_pad = max(int(counts.max()), 1)
        send_off = np.concatenate(
            [np.zeros((ind_n, 1), np.int32),
             np.cumsum(counts, axis=1, dtype=np.int32)[:, :-1]],
            axis=1,
        )  # send_off[i, j]: offset of the i->j emigrants in deme i's perm
        recv_total = counts.sum(axis=0).astype(np.int32)  # arrivals per deme
        # ordinal of arrival (i, s) within deme j's replacement slots
        recv_off = np.concatenate(
            [np.zeros((1, ind_n), np.int32),
             np.cumsum(counts, axis=0, dtype=np.int32)[:-1, :]],
            axis=0,
        )

    def local_step(state, key):
        i = jax.lax.axis_index("ind")
        j = jax.lax.axis_index("loci")
        hap = state["hap"]
        k_ind = jax.random.fold_in(key, i)  # loci-invariant: mating
        k_loc = jax.random.fold_in(k_ind, 1 + j)  # per-shard: xo/mutation
        k_mate, k_mig = jax.random.split(k_ind)
        k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(k_loc, 4)

        if cfg.selection:
            # phenotype from the resident CV matrix (replicated along
            # 'loci'); allele-frequency centering is GLOBAL — one integer
            # psum of allele counts over 'ind' (exact, order-invariant) —
            # so the A-model matches the panmictic/reference definition
            # (`Simulation.cpp:2647-2663`) even though parents stay
            # deme-local
            cvm = state["cv"]
            t = (cvm[:, 0] + cvm[:, 1]).astype(jnp.int32)
            tsum = jax.lax.psum(jnp.sum(t, axis=0), "ind")
            p_glob = tsum.astype(jnp.float32) / (2.0 * n_loc * ind_n)
            bv = jnp.dot(
                t.astype(jnp.float32) - 2.0 * p_glob[None, :], state["eff"],
                precision=jax.lax.Precision.HIGHEST,
            )
            # global standardization too (SV is standardized to global
            # moments in the reference, `Simulation.cpp:3324-3339`)
            N = float(n_loc * ind_n)
            mu_g = jax.lax.psum(jnp.sum(bv), "ind") / N
            var_g = jax.lax.psum(jnp.sum((bv - mu_g) ** 2), "ind") / N
            z = (bv - mu_g) / (jnp.sqrt(var_g) + 1e-9)
            km1, km2 = jax.random.split(k_mate)
            fathers = jax.random.categorical(km1, z, shape=(n_loc,))
            mothers = jax.random.categorical(km2, z, shape=(n_loc,))
        else:
            km1, km2 = jax.random.split(k_mate)
            fathers = jax.random.randint(km1, (n_loc,), 0, n_loc)
            mothers = jax.random.randint(km2, (n_loc,), 0, n_loc)

        xo_p, st_p, clip_p = _sample_gamete_plan(k_pat, dense_loc, n_loc)
        xo_m, st_m, clip_m = _sample_gamete_plan(k_mat, dense_loc, n_loc)
        clip = clip_p + clip_m
        mu = None
        if cfg.mut_rate > 0:
            mu_a, clip_a = mutation_positions(k_mu1, n_loc, cfg_loc)
            mu_b, clip_b = mutation_positions(k_mu2, n_loc, cfg_loc)
            mu = jnp.stack([mu_a, mu_b], axis=1)
            clip = clip + clip_a + clip_b
        child = reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu)

        # advance the CV matrix: each loci shard applies its own local
        # crossover/mutation plan to the columns it owns, everything else
        # masked to zero; one small psum over 'loci' reassembles the full
        # replicated (n_loc, 2, ncv) matrix
        lo = j * m_loc
        cv_idx = state["cv_idx"]  # global columns, replicated
        inrange = (cv_idx >= lo) & (cv_idx < lo + m_loc)
        idx_loc = jnp.clip(cv_idx - lo, 0, m_loc - 1)
        parts = []
        for g, (par, xo, st) in enumerate(
            ((fathers, xo_p, st_p), (mothers, xo_m, st_m))
        ):
            gam = cv_child(
                state["cv"], par, xo, st,
                None if mu is None else mu[:, g],
                idx_loc, cfg_loc.chr_len,
            )
            parts.append(gam * inrange[None, :].astype(jnp.uint8))
        cv = jax.lax.psum(
            jnp.stack(parts, axis=1).astype(jnp.int32), "loci"
        ).astype(jnp.uint8)

        if n_emig:
            # sample emigrants without replacement with a loci-invariant key
            # (k_mig derives from k_ind), so every loci shard moves the same
            # individuals; ring ppermute over 'ind' between devices
            slots = jax.random.permutation(k_mig, n_loc)[:n_emig]
            ring = [(s, (s + 1) % ind_n) for s in range(ind_n)]
            incoming = jax.lax.ppermute(child[slots], "ind", ring)
            child = child.at[slots].set(incoming)
            cv = cv.at[slots].set(jax.lax.ppermute(cv[slots], "ind", ring))
        if counts is not None:
            # general row-stochastic migration as one all_to_all transpose:
            # deme i's slot j carries its k_ij emigrants (k_pad-padded);
            # after the exchange, entry [i] holds deme i's arrivals here.
            cnt = jnp.asarray(counts)
            soff = jnp.asarray(send_off)
            roff = jnp.asarray(recv_off)
            perm = jax.random.permutation(k_mig, n_loc)  # loci-invariant
            lane = jnp.arange(k_pad)[None, :]
            s_idx = soff[i][:, None] + lane  # (D, k_pad) into perm
            rows = perm[jnp.clip(s_idx, 0, n_loc - 1)]
            recv_hap = jax.lax.all_to_all(child[rows], "ind", 0, 0)
            recv_cv = jax.lax.all_to_all(cv[rows], "ind", 0, 0)
            # arrivals replace the departed slots first (perm order), then
            # further residents when inflow exceeds outflow
            valid = lane < cnt[:, i][:, None]  # (D, k_pad) arrivals from i
            ord_ = roff[:, i][:, None] + lane
            slot = jnp.where(
                valid, perm[jnp.clip(ord_, 0, n_loc - 1)], n_loc
            ).ravel()  # n_loc = out of bounds -> dropped
            child = child.at[slot].set(
                recv_hap.reshape(-1, *child.shape[1:]), mode="drop"
            )
            cv = cv.at[slot].set(
                recv_cv.reshape(-1, *cv.shape[1:]), mode="drop"
            )
        return {
            "hap": child,
            "cv": cv,
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            # replicated total across the whole mesh
            "clip": state.get("clip", 0)
            + jax.lax.psum(clip, ("ind", "loci")),
        }

    specs = state_specs(packed=True)
    # cv_idx/eff replicated; haplotypes block-sharded
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(specs, P()),
            out_specs=specs,
            check_vma=False,
        )
    )


# ---------------------------------------------------------------- routed
def routed_fetch(local_rows, global_idx, nloc: int, n_dev: int, cap: int,
                 axis: str = "ind"):
    """Distributed row gather inside shard_map: fetch `global_idx` rows of
    an 'ind'-sharded array via request-routing instead of a parent-plane
    all-gather.

    Each shard sorts its requests by owning shard, exchanges (D, cap)
    index packets with one all_to_all, serves its local rows, and returns
    them with a second all_to_all. Per-device traffic is
    O(R/D * row_bytes) (R = len(global_idx)) versus the all-gather's
    O(n * row_bytes) — the 'children on parent shards' restructure in
    its two-parent-correct form (a child's father and
    mother live on different shards with prob. 1 - 1/D, so the row
    exchange, not a child permute, is the irreducible communication).

    `cap` must bound the per-owner request count; overflowing requests are
    dropped by the scatter and the second return value counts them
    (choose cap ~ R/D + 6*sqrt(R/D) + 8 for ~zero overflow).
    """
    D = n_dev
    R = global_idx.shape[0]
    my = jax.lax.axis_index(axis)
    owner = jnp.clip(global_idx // nloc, 0, D - 1).astype(jnp.int32)
    order = jnp.argsort(owner, stable=True)
    owner_s = owner[order]
    idx_s = global_idx[order]
    cnt = jnp.bincount(owner_s, length=D)
    base = jnp.cumsum(cnt) - cnt  # exclusive prefix
    pos = jnp.arange(R, dtype=jnp.int32) - base[owner_s]
    overflow = jnp.sum(pos >= cap)
    req = jnp.full((D, cap), -1, dtype=jnp.int32)
    req = req.at[owner_s, pos].set(idx_s.astype(jnp.int32), mode="drop")
    req_in = jax.lax.all_to_all(
        req[:, None], axis, split_axis=0, concat_axis=0
    )[:, 0].reshape(D, cap)
    loc = jnp.clip(req_in - my * nloc, 0, nloc - 1).reshape(-1)
    served = local_rows[loc].reshape((D, cap) + local_rows.shape[1:])
    back = jax.lax.all_to_all(
        served[:, None], axis, split_axis=0, concat_axis=0
    )[:, 0].reshape(served.shape)
    flat = back.reshape((D * cap,) + local_rows.shape[1:])
    slot = jnp.clip(owner_s * cap + pos, 0, D * cap - 1)
    got_sorted = flat[slot]
    out = jnp.zeros((R,) + local_rows.shape[1:], dtype=local_rows.dtype)
    out = out.at[order].set(got_sorted)
    return out, overflow


def make_routed_step(cfg, mesh: Mesh):
    """Panmictic sharded generation step with request-routed parent
    fetches (shard_map): EXACT global-mating law like `make_sharded_step`
    (global selection, any parent reachable from any child), but the
    cross-shard communication is two row-exchange all_to_alls per parent
    set instead of an all-gather of the parent planes — per-device traffic
    drops by ~D/4. Not yet timed against the all-gather form on GPUs.

    Children keep their resident shard (child c lives on shard
    c // (n/D)); mates are drawn from the GLOBAL standardized phenotype
    (one small all_gather of the (n,) selection vector), and the parents'
    hap/CV rows are fetched with `routed_fetch`. The random stream differs
    from the unsharded step (per-shard plan keys) — same law, different
    draws, like deme mode."""
    from geneevolve_tpu.dense.packed import (
        PackedConfig,
        cv_child,
        make_reproduce,
        mutation_positions,
    )
    from geneevolve_tpu.dense.step import _sample_gamete_plan

    assert isinstance(cfg, PackedConfig)
    ind_n, loci_n = mesh.devices.shape
    assert cfg.n % ind_n == 0 and cfg.n_chr % loci_n == 0
    nloc = cfg.n // ind_n
    cfg_loc = PackedConfig(**{
        **cfg.__dict__,
        "n": nloc,
        "m": cfg.m // loci_n,
        "n_chr": cfg.n_chr // loci_n,
    })
    reproduce = make_reproduce(cfg_loc)
    dense_loc = cfg_loc.as_dense()
    R = 2 * nloc
    cap = int(R // ind_n + 6 * np.sqrt(max(R // ind_n, 1)) + 8)

    m_loc = cfg_loc.m

    def local_step(state, key):
        hap = state["hap"]  # (nloc, 2, mwloc)
        cv = state["cv"]  # (nloc, 2, ncv) — replicated along 'loci'
        i = jax.lax.axis_index("ind")
        j = jax.lax.axis_index("loci")
        k_mate = jax.random.fold_in(key, 0)  # mesh-invariant: mating
        k_loc = jax.random.fold_in(  # per-shard: xo/mutation plans
            jax.random.fold_in(key, 1 + i), 1 + j
        )
        km1, km2 = jax.random.split(k_mate)

        if cfg.selection:
            # global A-model + global standardization, as in deme mode —
            # then the full (n,) z (one small all_gather) so ANY parent is
            # reachable from any child: exact panmictic mating law
            t = (cv[:, 0] + cv[:, 1]).astype(jnp.int32)
            tsum = jax.lax.psum(jnp.sum(t, axis=0), "ind")
            p_glob = tsum.astype(jnp.float32) / (2.0 * cfg.n)
            bv = jnp.dot(
                t.astype(jnp.float32) - 2.0 * p_glob[None, :], state["eff"],
                precision=jax.lax.Precision.HIGHEST,
            )
            N = float(cfg.n)
            mu_g = jax.lax.psum(jnp.sum(bv), "ind") / N
            var_g = jax.lax.psum(jnp.sum((bv - mu_g) ** 2), "ind") / N
            z_loc = (bv - mu_g) / (jnp.sqrt(var_g) + 1e-9)
            z = jax.lax.all_gather(z_loc, "ind").reshape(-1)  # (n,)
            fathers = jax.random.categorical(km1, z, shape=(cfg.n,))
            mothers = jax.random.categorical(km2, z, shape=(cfg.n,))
        else:
            fathers = jax.random.randint(km1, (cfg.n,), 0, cfg.n)
            mothers = jax.random.randint(km2, (cfg.n,), 0, cfg.n)
        f_loc = jax.lax.dynamic_slice(fathers, (i * nloc,), (nloc,))
        m_loc_idx = jax.lax.dynamic_slice(mothers, (i * nloc,), (nloc,))
        want = jnp.concatenate([f_loc, m_loc_idx])

        par_hap, ov1 = routed_fetch(hap, want, nloc, ind_n, cap)
        par_cv, ov2 = routed_fetch(cv, want, nloc, ind_n, cap)

        k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(k_loc, 4)
        xo_p, st_p, clip_p = _sample_gamete_plan(k_pat, dense_loc, nloc)
        xo_m, st_m, clip_m = _sample_gamete_plan(k_mat, dense_loc, nloc)
        clip = clip_p + clip_m
        mu = None
        if cfg.mut_rate > 0:
            mu_a, ca = mutation_positions(k_mu1, nloc, cfg_loc)
            mu_b, cb = mutation_positions(k_mu2, nloc, cfg_loc)
            mu = jnp.stack([mu_a, mu_b], axis=1)
            clip = clip + ca + cb
        fi = jnp.arange(nloc, dtype=jnp.int32)
        mi = fi + nloc
        child = reproduce(par_hap, fi, mi, xo_p, st_p, xo_m, st_m, mu)

        # CV matrix: each loci shard applies its local plan to the columns
        # it owns, psum over 'loci' reassembles (deme-mode pattern)
        lo = j * m_loc
        cv_idx = state["cv_idx"]
        inrange = (cv_idx >= lo) & (cv_idx < lo + m_loc)
        idx_loc = jnp.clip(cv_idx - lo, 0, m_loc - 1)
        parts = []
        for g, (par, xo, st) in enumerate(
            ((fi, xo_p, st_p), (mi, xo_m, st_m))
        ):
            gam = cv_child(
                par_cv, par, xo, st,
                None if mu is None else mu[:, g],
                idx_loc, cfg_loc.chr_len,
            )
            parts.append(gam * inrange[None, :].astype(jnp.uint8))
        new_cv = jax.lax.psum(
            jnp.stack(parts, axis=1).astype(jnp.int32), "loci"
        ).astype(jnp.uint8)

        return {
            "hap": child,
            "cv": new_cv,
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            "clip": state.get("clip", 0)
            + jax.lax.psum(clip + ov1 + ov2, ("ind", "loci")),
        }

    specs = state_specs(True)
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(specs, P()),
            out_specs=specs,
            check_vma=False,
        )
    )
