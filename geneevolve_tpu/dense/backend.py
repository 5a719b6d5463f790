"""Dense genome backend for the full scenario pipeline (`--backend dense`).

`DenseSimulation` runs the SAME GeneEvolve scenario semantics as the
segment engine — assortative/random mating with selection gates
(`/root/reference/src/Simulation.cpp:2090-2360`), A/D with per-generation
allele frequencies (`:2624-2749`), E/F/C/P assembly and gen-0 scaling
(`:3075-3206`), MV/SV + selection functions (`:3300-3428`), info/summary
files — but keeps the genome materialized as bit-packed chromatid planes
(`dense/packed.py`), so each generation is one fused meiosis pass instead
of a segment-ledger merge. This is the
flagship-throughput path applied to real scenarios: genotype output needs
no painting (the genome IS the genotypes), and per-generation cost is the
benchmarked ind*loci*gens/s rate.

Multi-population scenarios are supported: every population keeps its own
packed panel and map CDFs (`_DensePanel`), and migration is a plain row
move between planes (`_gather_state`) — materialized genomes need no
founder-reference remapping. Panels must share identical loci per
chromosome (validated at load), exactly the alignment the reference's
painting assumes. Scope (validated in config.py): no `.int` output (no
ledger). Per-CV crossover placement resolves at panel-column granularity
(crossover positions are sampled in map space and mapped to columns, so a
crossover falling between two panel columns that also straddle a CV's
interpolated column is indistinguishable from one just past it — exact for
CVs at panel sites, sub-bin approximation otherwise).

De novo mutations follow `ras_add_mutation` (`Simulation.cpp:2497-2552`)
restricted to panel sites: a mutation only ever changes genotypes when it
coincides with a panel position (`:1218-1222` flips at paint time), so the
dense law flips column c with the map's per-bp intensity at c's position —
the same observable distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from geneevolve_tpu.core import mating, phenotype
from geneevolve_tpu.core.engine import (
    PopRuntime,
    Simulation,
    SimulationError,
)
from geneevolve_tpu.core.rng import Stage, stage_key
from geneevolve_tpu.dense.packed import (
    PackedConfig,
    cv_child,
    make_reproduce,
    pack_bits,
    unpack_bits,
)
from geneevolve_tpu.dense.step import _sample_gamete_plan
from geneevolve_tpu.io import hap as hap_io
from geneevolve_tpu.io import plink as plink_io
from geneevolve_tpu.io import vcf as vcf_io


@dataclass
class DensePopState:
    """Duck-typed PopState for the dense backend: same host fields, genome
    as packed planes + per-phenotype resident CV matrices."""

    n: int
    hap: jax.Array  # (n, 2, mw) uint32
    cv: List[jax.Array]  # per phenotype: (n, 2, ncv_j) uint8
    sex: np.ndarray
    ids: np.ndarray
    ped: Dict[str, np.ndarray]
    comp: Dict[str, np.ndarray]
    mv: np.ndarray
    sv: np.ndarray
    svf: np.ndarray


@dataclass
class _DensePanel:
    """One population's packed founder panel + per-column map tables."""

    legends: List
    m_real: List[int]
    xo_cdf: jax.Array  # (m,) per-column crossover CDF
    mut_lambda: float
    mut_cdf: Optional[jax.Array]
    founder_hap: jax.Array  # (n0, 2, mw) uint32
    cv_cols: List[jnp.ndarray]  # per phenotype
    dense_cfg: PackedConfig


class DenseSimulation(Simulation):
    def __init__(self, cfg, verbose: bool = True, mesh=None):
        # the base engine's mesh plumbing pads/shards (nchr, n, ...) ledger
        # arrays on axis 1; dense planes are (n, 2, mw) sharded on axis 0,
        # so the mesh is held here and applied by _put_plane instead
        super().__init__(cfg, verbose=verbose, mesh=None)
        self.mesh = None
        # the meiosis kernel on unsharded runs (it has no partitioning
        # rule); sharded runs take the XLA formulation
        self.kernels = mesh is None
        if mesh is not None:
            if "ind" not in mesh.axis_names:
                raise SimulationError("mesh must have an 'ind' axis")
            self.mesh = mesh
        # realized generation size follows the reference Poisson law
        # (`Simulation.cpp:2329-2337`), same as the segment engine: plane
        # rows absorb the jitter via _child_rows headroom + parent-row
        # reuse, so shapes stay stable and programs are not recompiled
        # (GE_EXACT_N=1 restores the conditioned fixed-N law, handled by
        # the base __init__)

    def _plane_spec(self, ndim: int, shard_loci: bool):
        from jax.sharding import NamedSharding, PartitionSpec

        spec = [None] * ndim
        spec[0] = "ind"
        if shard_loci and ndim >= 3 and "loci" in self.mesh.axis_names:
            spec[-1] = "loci"  # packed word axis
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def _put_plane(self, x):
        """Shard a dense per-individual array (n leading axis) over the
        mesh: individuals on 'ind' (rows edge-padded to a mesh multiple —
        masked from statistics, sliced from outputs), packed words on
        'loci' when the trailing axis is the packed uint32 word axis (only
        that axis carries the mesh-divisibility guarantee; CV matrices
        (n, 2, ncv) have arbitrary trailing size and stay replicated on
        'loci')."""
        if self.mesh is None:
            return x
        m = self.mesh.shape["ind"]
        n_pad = ((x.shape[0] + m - 1) // m) * m
        if n_pad != x.shape[0]:
            pad = [(0, 0)] * x.ndim
            pad[0] = (0, n_pad - x.shape[0])
            x = jnp.pad(x, pad, mode="edge")
        shard_loci = x.dtype == jnp.uint32
        return jax.device_put(x, self._plane_spec(x.ndim, shard_loci))

    # ------------------------------------------------------------ panel load
    def _load_all_panels(self) -> None:
        """Read every population's founder panel once, fix a GLOBAL padded
        chromosome length (so packed planes are row-compatible across
        populations — migration is then a plain row move), and build each
        population's per-column CDFs/CV columns via `_load_panel`."""
        if getattr(self, "_dp", None):
            return
        self._dp = {}
        raw = {}
        for p in self.pops:
            panels, legends, m_real = [], [], []
            for ic, c in enumerate(self.chrs):
                if p.vcf_addresses:
                    v = vcf_io.read_vcf(p.vcf_addresses[ic][1])
                    legends.append(v)
                    panels.append(v.hap)  # (2n0, m_chr)
                else:
                    _, hap_path, legend_path, _ = p.hap_addresses[ic]
                    legends.append(hap_io.read_legend(legend_path))
                    panels.append(hap_io.read_hap(hap_path))
                m_real.append(panels[-1].shape[1])
            raw[p.index] = (panels, legends, m_real)
        # cross-population compatibility: identical loci per chromosome
        # (the reference paints every population against per-chromosome
        # legends of equal length, `Simulation.cpp:1105-1230`)
        ref_legs = raw[self.pops[0].index][1]
        for p in self.pops[1:]:
            for ic, leg in enumerate(raw[p.index][1]):
                if not np.array_equal(leg.pos, ref_legs[ic].pos):
                    raise SimulationError(
                        "--backend dense with multiple populations needs "
                        f"identical panel loci per chromosome; chr "
                        f"{self.chrs[ic]} differs between populations 1 "
                        f"and {p.index + 1}"
                    )
        # chromosomes padded to whole 32-locus words
        m_max = max(max(mr) for _, _, mr in raw.values())
        self._chr_len = -(-m_max // 32) * 32
        for p in self.pops:
            self._dp[p.index] = self._load_panel(p, *raw[p.index])

    def _load_panel(self, p: PopRuntime, panels, legends, m_real):
        """Pack one population's panel and build its per-column
        crossover/mutation CDFs and CV column positions."""
        chr_len = self._chr_len
        xo_cdf, mut_cdf, total, mtotal = [], [], 0.0, 0.0
        planes_a, planes_b = [], []
        for ic, (panel, leg) in enumerate(zip(panels, legends)):
            pos = leg.pos
            r = p.rmaps[self.chrs[ic]]
            cm = np.interp(pos, r.bp, r.cM)
            mass = np.diff(cm, prepend=cm[0]) / 100.0
            cdf = total + np.cumsum(mass)
            total = cdf[-1]
            xo_cdf.append(_pad_tail(cdf, chr_len, total))
            m = p.maps[ic]
            if m.mut_lambda > 0:
                # per-bp intensity of the column's map bin
                rate = np.diff(np.asarray(m.mut_cum, np.float64), prepend=0.0)
                width = float(p.rmaps[self.chrs[ic]].bin_width)
                bins = np.clip(
                    np.searchsorted(np.asarray(m.mut_bp), pos, "right") - 1,
                    0, len(rate) - 1,
                )
                inten = rate[bins] / max(width, 1.0)
                mc = mtotal + np.cumsum(inten)
                mtotal = mc[-1]
                mut_cdf.append(_pad_tail(mc, chr_len, mtotal))
            else:
                mut_cdf.append(np.full(chr_len, mtotal))
            planes_a.append(_pad_cols(panel[0::2], chr_len))
            planes_b.append(_pad_cols(panel[1::2], chr_len))
        m_tot = chr_len * len(self.chrs)
        mut_lambda = float(mtotal)
        cv_cols: List[jnp.ndarray] = []
        for j in range(self.n_pheno):
            # CV columns: the column a CV's bp maps to (exact when the CV
            # is a panel site; insertion point otherwise)
            cols = []
            for ic, leg in enumerate(legends):
                bp = p.phenos[j].cv_bp[ic]
                idx = np.minimum(
                    np.searchsorted(leg.pos, bp), len(leg.pos) - 1
                )
                cols.append(idx + ic * chr_len)
            cv_cols.append(
                jnp.asarray(np.concatenate(cols), dtype=jnp.int32)
            )
        L = max(m.xo_lambda for m in p.maps)
        return _DensePanel(
            legends=legends,
            m_real=m_real,
            xo_cdf=jnp.asarray(np.concatenate(xo_cdf), dtype=jnp.float32),
            mut_lambda=mut_lambda,
            mut_cdf=(
                jnp.asarray(np.concatenate(mut_cdf), dtype=jnp.float32)
                if mtotal > 0
                else None
            ),
            founder_hap=jnp.stack(
                [
                    pack_bits(jnp.asarray(np.concatenate(planes_a, axis=1))),
                    pack_bits(jnp.asarray(np.concatenate(planes_b, axis=1))),
                ],
                axis=1,
            ),
            cv_cols=cv_cols,
            dense_cfg=PackedConfig(
                n=0,  # per-call
                m=m_tot,
                n_chr=len(self.chrs),
                xo_cap=int(8 + np.ceil(L + 6 * np.sqrt(max(L, 1.0)))),
                mut_rate=mut_lambda,
                mut_cap=int(
                    4 + np.ceil(mut_lambda
                                + 6 * np.sqrt(max(mut_lambda, 0.25)))
                ),
                ncv=0,
            ),
        )

    # ------------------------------------------------------------------ gen0
    def _init_gen0_state(self, p: PopRuntime) -> DensePopState:
        self._load_all_panels()
        n = p.n_founders
        cv = [
            jnp.asarray(
                np.stack(
                    [
                        np.concatenate(
                            [fc[0::2] for fc in p.phenos[j].founder_cv],
                            axis=1,
                        ),
                        np.concatenate(
                            [fc[1::2] for fc in p.phenos[j].founder_cv],
                            axis=1,
                        ),
                    ],
                    axis=1,
                )
            )
            for j in range(self.n_pheno)
        ]  # (n, 2, ncv_j)
        return DensePopState(
            hap=self._put_plane(self._dp[p.index].founder_hap),
            cv=[self._put_plane(c) for c in cv],
            **self._gen0_host_fields(p, n),
        )

    # ------------------------------------------------------------- reproduce
    def _reproduce(self, p: PopRuntime, gen: int, plan: mating.MatingPlan):
        st = p.state
        dp = self._dp[p.index]
        n_child = len(plan.child_father)
        n_pad = self._child_rows(p, gen, n_child, st.hap.shape[0])
        cfg = PackedConfig(**{**dp.dense_cfg.__dict__, "n": n_pad})
        # pad children to a mesh multiple with copies of couple 0 (draws
        # are prefix-stable in the leading axis; padding rows are masked
        # from statistics and sliced from outputs)
        fathers = self._put_plane(jnp.asarray(
            np.pad(plan.child_father, (0, n_pad - n_child)), dtype=jnp.int32
        ))
        mothers = self._put_plane(jnp.asarray(
            np.pad(plan.child_mother, (0, n_pad - n_child)), dtype=jnp.int32
        ))
        key = stage_key(self.key, gen, Stage.CROSSOVER, p.index)
        gplan = _gamete_plans(key, dp.xo_cdf, dp.mut_cdf, cfg)
        child = _reproduce_planes(st.hap, fathers, mothers, *gplan, cfg=cfg,
                                  kernels=self.kernels)
        cv = [
            _child_cv(st.cv[j], fathers, mothers, *gplan, dp.cv_cols[j],
                      chr_len=self._chr_len)
            for j in range(self.n_pheno)
        ]
        return DensePopState(
            hap=child, cv=cv, **self._child_host_fields(p, gen, plan)
        )

    # ------------------------------------------------------------- migration
    def _gather_state(self, parts) -> DensePopState:
        """Concatenate selected rows of several populations' dense states —
        migration is a plain row move: genomes are materialized planes (no
        founder references to remap), and the resident CV matrices travel
        with their rows (`ras_do_migration` semantics,
        `Simulation.cpp:877-989`; planes are cross-population compatible by
        the identical-loci validation in `_load_all_panels`)."""
        hap = jnp.concatenate(
            [
                src.state.hap[jnp.asarray(idx, dtype=jnp.int32)]
                for src, idx in parts
            ],
            axis=0,
        )
        cv = [
            jnp.concatenate(
                [
                    src.state.cv[j][jnp.asarray(idx, dtype=jnp.int32)]
                    for src, idx in parts
                ],
                axis=0,
            )
            for j in range(self.n_pheno)
        ]
        return DensePopState(
            hap=self._put_plane(hap),
            cv=[self._put_plane(c) for c in cv],
            **self._gather_host_fields(parts),
        )

    # ------------------------------------------------------------------- A/D
    def _compute_ad(self, p: PopRuntime, gen: int = -1):
        st = p.state
        A = np.zeros((self.n_pheno, st.n))
        D = np.zeros((self.n_pheno, st.n))
        for j in range(self.n_pheno):
            if sum(self.ncv_real[j]) == 0:
                continue
            a = np.concatenate(p.phenos[j].a)
            d = np.concatenate(p.phenos[j].d)
            a_t = jnp.broadcast_to(
                jnp.asarray(a, jnp.float32), st.cv[j].shape[::2]
            )
            d_t = jnp.broadcast_to(
                jnp.asarray(d, jnp.float32), st.cv[j].shape[::2]
            )
            A_j, D_j = phenotype.additive_dominance_chr(
                st.cv[j][:, 0],
                st.cv[j][:, 1],
                a_t,
                a_t,
                d_t,
                d_t,
                jnp.asarray(p.phenos[j].vd != 0),
                jnp.asarray(st.n, dtype=jnp.int32),  # mask mesh padding
            )
            A[j] = np.asarray(A_j, dtype=np.float64)[: st.n]
            D[j] = np.asarray(D_j, dtype=np.float64)[: st.n]
        return A, D

    # ------------------------------------------------------------ checkpoint
    def _ckpt_genome_arrays(self, st: DensePopState) -> dict:
        d = {"hap": np.asarray(st.hap[: st.n])}
        for j in range(self.n_pheno):
            d[f"dcv{j}"] = np.asarray(st.cv[j][: st.n])
        return d

    def _ckpt_make_state(self, z, pre: str, host: dict) -> DensePopState:
        self._load_all_panels()  # resume skips gen0: panels load here
        return DensePopState(
            hap=self._put_plane(jnp.asarray(z[f"{pre}.hap"])),
            cv=[
                self._put_plane(jnp.asarray(z[f"{pre}.dcv{j}"]))
                for j in range(self.n_pheno)
            ],
            **host,
        )

    # --------------------------------------------------------------- outputs
    def save_genotypes(self, gen: int) -> None:
        for p in self.pops:
            self._save_genotypes_pop(p, gen)

    def _save_genotypes_pop(self, p: PopRuntime, gen: int) -> None:
        cfg = self.cfg
        st = p.state
        dp = self._dp[p.index]
        for ic, chrom in enumerate(self.chrs):
            base = f"{cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
            leg = dp.legends[ic]
            mr = dp.m_real[ic]
            lo_w = ic * self._chr_len // 32
            hi_w = (ic + 1) * self._chr_len // 32
            a = np.asarray(
                unpack_bits(st.hap[: st.n, 0, lo_w:hi_w], self._chr_len)
            )[:, :mr]
            b = np.asarray(
                unpack_bits(st.hap[: st.n, 1, lo_w:hi_w], self._chr_len)
            )[:, :mr]
            pos = leg.pos
            if cfg.out_hap:
                mat = np.empty((2 * st.n, mr), dtype=np.uint8)
                mat[0::2] = a
                mat[1::2] = b
                hap_io.write_hap(base + ".hap", mat)
                hap_io.write_indv(base + ".indv", st.ids + 1)
            if cfg.out_vcf:
                m = len(pos)
                v = vcf_io.VcfData(
                    samples=[f"g{gen}_{i + 1}" for i in st.ids],
                    chrom=np.full(m, str(chrom), dtype=object),
                    pos=pos,
                    ids=_lg(leg, "ids"),
                    ref=_lg(leg, "al0"),
                    alt=_lg(leg, "al1"),
                    qual=np.full(m, ".", dtype=object),
                    filt=np.full(m, ".", dtype=object),
                    info=np.full(m, ".", dtype=object),
                    fmt=np.full(m, "GT", dtype=object),
                    hap=np.empty((0, 0), dtype=np.uint8),
                    meta_lines=vcf_io.default_meta_lines(),
                )
                if isinstance(leg, vcf_io.VcfData):
                    v.chrom, v.qual, v.filt = leg.chrom, leg.qual, leg.filt
                w = vcf_io.VcfStreamWriter(base + ".vcf", v)
                w.write_block(0, a, b)
                w.close()
            if cfg.out_plink or cfg.out_plink01:
                ids = plink_io.PedIds(
                    fid=st.ped["father"] + 1,
                    iid=st.ids + 1,
                    pid=st.ped["father"] + 1,
                    mid=st.ped["mother"] + 1,
                    sex=st.sex,
                )
                geno = np.stack([a, b], axis=2)  # (n, m, 2)
                plink_io.write_ped_map(
                    base, geno, ids, chrom, _lg(leg, "ids"), pos,
                    _lg(leg, "al0"), _lg(leg, "al1"), letters=cfg.out_plink,
                )


def _lg(leg, attr):
    if isinstance(leg, vcf_io.VcfData):
        return {"ids": leg.ids, "al0": leg.ref, "al1": leg.alt}[attr]
    return getattr(leg, attr)


def _pad_cols(x: np.ndarray, length: int) -> np.ndarray:
    if x.shape[1] == length:
        return x
    pad = np.zeros((x.shape[0], length - x.shape[1]), dtype=x.dtype)
    return np.concatenate([x, pad], axis=1)


def _pad_tail(x: np.ndarray, length: int, value: float) -> np.ndarray:
    if len(x) == length:
        return x
    return np.concatenate([x, np.full(length - len(x), value)])


@partial(jax.jit, static_argnames=("cfg",))
def _gamete_plans(key, xo_cdf, mut_cdf, cfg: PackedConfig):
    """Both gametes' crossover plans and de novo mutation columns for
    `cfg.n` children: (xo_p, st_p, xo_m, st_m, mu), mu None without a
    mutation map."""
    k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(key, 4)
    xo_p, st_p, _ = _sample_gamete_plan(k_pat, cfg.as_dense(), cfg.n, xo_cdf)
    xo_m, st_m, _ = _sample_gamete_plan(k_mat, cfg.as_dense(), cfg.n, xo_cdf)
    mu = None
    if mut_cdf is not None:
        mu = jnp.stack(
            [
                _mutation_cols(k_mu1, cfg.n, cfg, mut_cdf),
                _mutation_cols(k_mu2, cfg.n, cfg, mut_cdf),
            ],
            axis=1,
        )
    return xo_p, st_p, xo_m, st_m, mu


@partial(jax.jit, static_argnames=("cfg", "kernels"))
def _reproduce_planes(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu,
                      cfg: PackedConfig, kernels: bool = False):
    """(n, 2, mw) child planes: one fused word-mask meiosis pass. With
    `kernels` (unsharded runs), the CUDA lowering runs the Triton kernel
    (`ops/meiosis_triton.py`, bit-equal to the XLA formulation)."""
    from geneevolve_tpu.ops.meiosis_triton import meiose_packed_triton

    args = (hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu)
    xla = make_reproduce(cfg)
    if not kernels:
        return xla(*args)
    return jax.lax.platform_dependent(
        *args, default=xla,
        cuda=partial(meiose_packed_triton, chr_len=cfg.chr_len),
    )


@partial(jax.jit, static_argnames=("chr_len",))
def _child_cv(cv, fathers, mothers, xo_p, st_p, xo_m, st_m, mu, cv_cols,
              chr_len: int):
    """(n, 2, ncv) child CV alleles under the same meiosis law."""
    return jnp.stack(
        [
            cv_child(cv, fathers, xo_p, st_p,
                     None if mu is None else mu[:, 0], cv_cols, chr_len),
            cv_child(cv, mothers, xo_m, st_m,
                     None if mu is None else mu[:, 1], cv_cols, chr_len),
        ],
        axis=1,
    )


def _mutation_cols(key, n: int, cfg: PackedConfig, cdf: jax.Array):
    """(n, mut_cap) de novo mutation columns by inverse-CDF over per-column
    intensities, pad = m (`ras_add_mutation` law at panel sites)."""
    k1, k2 = jax.random.split(key)
    counts = jnp.minimum(
        jax.random.poisson(k1, cfg.mut_rate, (n,)), cfg.mut_cap
    )
    u = jax.random.uniform(k2, (n, cfg.mut_cap), dtype=jnp.float32) * cdf[-1]
    pos = jnp.minimum(
        jnp.searchsorted(cdf, u, side="right"), cfg.m - 1
    ).astype(jnp.int32)
    valid = jnp.arange(cfg.mut_cap)[None, :] < counts[:, None]
    return jnp.where(valid, pos, cfg.m)
