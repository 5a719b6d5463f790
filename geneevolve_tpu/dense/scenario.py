"""Materialized fast path: run the bit-packed dense engine on a *real*
founder panel with a *real* recombination map.

This is the mode to use when every generation's genotypes are consumed
(GWAS-simulation pipelines, method benchmarking): the whole panel lives
on device as two packed chromatid planes, each generation is one fused
meiosis pass, and any generation can be written back out as .hap files.
The reference has no equivalent — its interval engine defers genotype
materialization to output time (`/root/reference/src/Simulation.cpp:
1186-1230`); here materialization *is* the evolution step.

Capabilities: hap/legend/indv founder input, map-aware Poisson crossovers,
de novo mutation, additive phenotype on CV columns with per-generation
allele-frequency centering, neutral or logistic directional selection,
hap output per requested generation.

Usage (module CLI):
    python -m geneevolve_tpu.dense.scenario \
        --file_hap_name <address file> --file_recom_map <map> \
        --gens 20 [--pop_size N] [--mut_rate L] [--selection] \
        [--out_hap] [--prefix out.dense] [--seed 1]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geneevolve_tpu.dense.packed import (
    PackedConfig,
    make_step,
    pack_bits,
    unpack_bits,
)
from geneevolve_tpu.io import hap as hap_io
from geneevolve_tpu.io import tables


@dataclass
class PanelScenario:
    cfg: PackedConfig
    state: dict
    xo_cdf: jax.Array  # (m_padded,) cumulative Morgans per column
    chrs: List[int]
    m_real: List[int]  # real SNPs per chromosome (before padding)
    legends: List  # per chr legend tables
    indv_ids: List[str]

    @property
    def chr_len(self) -> int:
        return self.cfg.chr_len


def _pad_to(x: np.ndarray, length: int, value) -> np.ndarray:
    if x.shape[-1] == length:
        return x
    pad = np.full((*x.shape[:-1], length - x.shape[-1]), value, x.dtype)
    return np.concatenate([x, pad], axis=-1)


def load_panel(
    file_hap_name: str,
    file_recom_map: str,
    cv_info: str = "",
    pop_size: Optional[int] = None,
    mut_rate: float = 0.0,
    selection: bool = False,
    ncv: int = 128,
    xo_cap: int = 8,
    seed: int = 1,
) -> PanelScenario:
    """Pack a hap/legend/indv founder panel into dense engine state.

    Chromosomes are padded to a common multiple-of-32 column count; padding
    columns carry zero map mass (never recombine) and are dropped at
    output."""
    addresses = tables.read_hap_address(file_hap_name)
    chrs = [a[0] for a in addresses]
    rmaps = tables.read_recom_map(file_recom_map, chrs)
    indv_ids = hap_io.read_indv(addresses[0][3])

    panels, legends, cMs, m_real = [], [], [], []
    for chrom, hap_path, legend_path, _ in addresses:
        panel = hap_io.read_hap(hap_path)  # (2n0, m_chr)
        legend = hap_io.read_legend(legend_path)
        r = rmaps[chrom]
        # cumulative cM at each SNP position (linear interp on the map)
        cm = np.interp(legend.pos, r.bp, r.cM)
        panels.append(panel)
        legends.append(legend)
        cMs.append(cm)
        m_real.append(panel.shape[1])

    # pad to whole 32-locus words; padding columns carry zero map mass and
    # are dropped at output
    chr_len = -(-max(m_real) // 32) * 32
    n0 = panels[0].shape[0] // 2
    m = chr_len * len(chrs)

    planes_a, planes_b, cdf = [], [], []
    total = 0.0
    for panel, cm, mr in zip(panels, cMs, m_real):
        a = _pad_to(panel[0::2], chr_len, 0)
        b = _pad_to(panel[1::2], chr_len, 0)
        planes_a.append(a)
        planes_b.append(b)
        # per-column cumulative Morgans; padding adds no mass
        mass = np.diff(cm, prepend=cm[0]) / 100.0
        c = total + np.cumsum(mass)
        total = c[-1]
        cdf.append(_pad_to(c, chr_len, total))
    hap = jnp.stack(
        [
            pack_bits(jnp.asarray(np.concatenate(planes_a, axis=1))),
            pack_bits(jnp.asarray(np.concatenate(planes_b, axis=1))),
        ],
        axis=1,
    )

    n = pop_size or n0
    cfg = PackedConfig(
        n=n,
        m=m,
        n_chr=len(chrs),
        xo_cap=xo_cap,
        mut_rate=mut_rate,
        mut_cap=max(4, int(np.ceil(mut_rate + 4 * np.sqrt(max(mut_rate, 1)))))
        if mut_rate > 0
        else 4,
        ncv=ncv,
        selection=selection,
    )
    key = jax.random.key(seed)
    if n != n0:
        # bootstrap the founders up/down to the requested population size
        rows = jax.random.randint(key, (n,), 0, n0)
        hap = hap[rows]

    if cv_info:
        info = tables.read_cv_info(cv_info, chrs)
        cols, effs = [], []
        for ic, chrom in enumerate(chrs):
            pos = info[chrom].bp
            idx = np.searchsorted(legends[ic].pos, pos)
            cols.append(idx + ic * chr_len)
            effs.append(info[chrom].a)
        cv_idx = jnp.asarray(np.concatenate(cols), dtype=jnp.int32)
        eff = jnp.asarray(np.concatenate(effs), dtype=jnp.float32)
        cfg = PackedConfig(**{**cfg.__dict__, "ncv": int(cv_idx.shape[0])})
    else:
        # neutral marker set spread over real columns
        cv_idx = jnp.asarray(
            np.linspace(0, m_real[0] - 1, cfg.ncv).astype(np.int32)
        )
        eff = jax.random.normal(
            jax.random.fold_in(key, 1), (cfg.ncv,), dtype=jnp.float32
        )

    from geneevolve_tpu.dense.packed import cv_from_planes

    state = {
        "hap": hap,
        "cv": cv_from_planes(hap, cv_idx),
        "cv_idx": cv_idx,
        "eff": eff,
        "clip": jnp.zeros((), jnp.int32),  # truncated-draw counter
    }
    return PanelScenario(
        cfg=cfg,
        state=state,
        xo_cdf=jnp.asarray(np.concatenate(cdf), dtype=jnp.float32),
        chrs=chrs,
        m_real=m_real,
        legends=legends,
        indv_ids=list(indv_ids),
    )


def evolve(
    sc: PanelScenario, gens: int, seed: int = 2, log=print,
    start_gen: int = 0, checkpoint_every: int = 0, checkpoint_path: str = "",
) -> dict:
    """Run generations [start_gen, gens); returns the final state.

    The per-generation key is fold_in(key(seed), g) — a pure function of
    (seed, g) — so a run resumed from a checkpoint at generation g continues
    bit-identically to the uninterrupted run."""
    step = jax.jit(make_step(sc.cfg, xo_cdf=sc.xo_cdf))
    state = sc.state
    key = jax.random.key(seed)
    for g in range(start_gen, gens):
        state = step(state, jax.random.fold_in(key, g))
        if checkpoint_every and (g + 1) % checkpoint_every == 0:
            sc.state = state
            save_checkpoint(sc, g + 1, seed, checkpoint_path)
    jax.block_until_ready(state)
    clip = int(state.get("clip", 0))
    if clip:
        log(
            f"WARNING: {clip} crossover/mutation Poisson draws were "
            f"truncated at cap (raise xo_cap/mut_cap)"
        )
    sc.state = state
    return state


CKPT_VERSION = 1


def save_checkpoint(sc: PanelScenario, gen: int, seed: int, path: str) -> None:
    """Atomic npz checkpoint of the packed engine state (the flagship path;
    the segment engine's is `core/checkpoint.py`). Stores the packed planes,
    CV columns/effects, the map CDF, and enough config identity to refuse a
    mismatched resume."""
    import io as _io
    import os as _os

    data = {
        "ckpt_version": CKPT_VERSION,
        "gen": gen,
        "seed": seed,
        "n": sc.cfg.n,
        "m": sc.cfg.m,
        "n_chr": sc.cfg.n_chr,
        "mut_rate": sc.cfg.mut_rate,
        "selection": sc.cfg.selection,
        "hap": np.asarray(sc.state["hap"]),
        "cv": np.asarray(sc.state["cv"]),
        "cv_idx": np.asarray(sc.state["cv_idx"]),
        "eff": np.asarray(sc.state["eff"]),
        "clip": np.asarray(sc.state.get("clip", 0)),
        "xo_cdf": np.asarray(sc.xo_cdf),
    }
    buf = _io.BytesIO()
    np.savez_compressed(buf, **data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    _os.replace(tmp, path)


def load_checkpoint(sc: PanelScenario, seed: int, path: str) -> int:
    """Restore a `save_checkpoint` file into `sc`; returns the generation to
    resume from (the next step runs fold_in(key, gen))."""
    z = np.load(path, allow_pickle=False)
    if int(z["ckpt_version"]) != CKPT_VERSION:
        raise RuntimeError(
            f"checkpoint version {int(z['ckpt_version'])} != {CKPT_VERSION}"
        )
    for k in ("n", "m", "n_chr"):
        if int(z[k]) != getattr(sc.cfg, k):
            raise RuntimeError(
                f"checkpoint {k}={int(z[k])} does not match scenario "
                f"{k}={getattr(sc.cfg, k)}"
            )
    if int(z["seed"]) != seed:
        raise RuntimeError(
            "checkpoint seed differs; a resumed run would not continue the "
            "same trajectory"
        )
    sc.state = {
        "hap": jnp.asarray(z["hap"]),
        "cv": jnp.asarray(z["cv"]),
        "cv_idx": jnp.asarray(z["cv_idx"]),
        "eff": jnp.asarray(z["eff"]),
        "clip": jnp.asarray(z["clip"] if "clip" in z else 0, jnp.int32),
    }
    return int(z["gen"])


def write_hap(sc: PanelScenario, prefix: str, gen: int) -> None:
    """Per-chromosome .hap/.indv output of the current state."""
    n = sc.state["hap"].shape[0]
    for ic, chrom in enumerate(sc.chrs):
        lo_w = ic * sc.chr_len // 32
        hi_w = (ic + 1) * sc.chr_len // 32
        a = unpack_bits(sc.state["hap"][:, 0, lo_w:hi_w], sc.chr_len)
        b = unpack_bits(sc.state["hap"][:, 1, lo_w:hi_w], sc.chr_len)
        mat = np.empty((2 * n, sc.m_real[ic]), dtype=np.uint8)
        mat[0::2] = np.asarray(a)[:, : sc.m_real[ic]]
        mat[1::2] = np.asarray(b)[:, : sc.m_real[ic]]
        base = f"{prefix}.gen{gen}.chr{chrom}"
        hap_io.write_hap(base + ".hap", mat)
        hap_io.write_indv(base + ".indv", np.arange(n) + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file_hap_name", required=True)
    ap.add_argument("--file_recom_map", required=True)
    ap.add_argument("--file_cv_info", default="")
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--pop_size", type=int, default=0)
    ap.add_argument("--mut_rate", type=float, default=0.0)
    ap.add_argument("--selection", action="store_true")
    ap.add_argument("--out_hap", action="store_true")
    ap.add_argument("--prefix", default="out.dense")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--checkpoint_every", type=int, default=0,
                    help="write <prefix>.ckpt.npz every N generations")
    ap.add_argument("--resume", default="",
                    help="resume from a checkpoint written by this CLI")
    args = ap.parse_args(argv)

    t0 = time.time()
    sc = load_panel(
        args.file_hap_name,
        args.file_recom_map,
        cv_info=args.file_cv_info,
        pop_size=args.pop_size or None,
        mut_rate=args.mut_rate,
        selection=args.selection,
        seed=args.seed,
    )
    print(
        f"panel: n={sc.cfg.n} chrs={sc.chrs} m={sc.cfg.m} "
        f"(packed {sc.cfg.mw * 4} bytes/chromatid), "
        f"total map = {float(sc.xo_cdf[-1]):.2f} Morgans"
    )
    start_gen = 0
    if args.resume:
        start_gen = load_checkpoint(sc, args.seed + 1, args.resume)
        print(f"resumed from {args.resume} at generation {start_gen}")
    evolve(
        sc, args.gens, seed=args.seed + 1, start_gen=start_gen,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=f"{args.prefix}.ckpt.npz",
    )
    print(f"evolved {args.gens - start_gen} generations in "
          f"{time.time() - t0:.1f} s")
    if args.out_hap:
        write_hap(sc, args.prefix, args.gens)
        print(f"wrote {args.prefix}.gen{args.gens}.chr*.hap")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
