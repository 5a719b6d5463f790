"""Genotype materialization ("painting") and the output dispatcher.

The segment ledger is painted over the founder panel with one device gather
per (individual, locus) — the vectorized replacement for the reference's
O(n·parts·m) interval-walk loops
(`/root/reference/src/Simulation.cpp:1186-1230, 1308-1416, 1690-1758`).
Founder panels are re-read per chromosome at output time for all populations
(migration means anyone may carry anyone's founders,
`Simulation.cpp:1105-1138`).

Output naming matches the reference:
`<prefix>.pop<i>.gen<g>.chr<c>.{hap,indv,ped,map,vcf,int}`.
"""

from __future__ import annotations

import os
import threading
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from geneevolve_tpu.core import segments
from geneevolve_tpu.io import hap as hap_io
from geneevolve_tpu.io import plink as plink_io
from geneevolve_tpu.io import vcf as vcf_io

_LOCI_CHUNK = 1 << 20


@partial(jax.jit, static_argnames=())
def _paint_chunk(seg_st, seg_hap, mut, founder, pos):
    """(n, 2, mc) alleles for a loci chunk: founder-row gather + mutation XOR."""
    rows = segments.hap_at(seg_st, seg_hap, pos)  # (n, 2, mc)
    bits = founder[rows, jnp.arange(pos.shape[0])[None, None, :]]
    flip = segments.mutation_flip_mask(mut, jnp.broadcast_to(pos, rows.shape))
    return jnp.where(flip, 1 - bits, bits).astype(jnp.uint8)


def paint_chunks(
    seg_st: jax.Array,  # (n, 2, S)
    seg_hap: jax.Array,
    mut: jax.Array,
    founder: np.ndarray,  # (H, m) uint8, concatenated over populations
    legend_pos: np.ndarray,  # (m,) int64
):
    """Yield (lo, (n, 2, mc) uint8) painted loci chunks — the streaming form:
    SNP-major outputs (.hap, VCF) consume each chunk and drop it, so peak
    host memory is one chunk x n, never n x m."""
    founder_d = jnp.asarray(founder, dtype=jnp.uint8)
    m = len(legend_pos)
    for lo in range(0, m, _LOCI_CHUNK):
        pos = jnp.asarray(
            legend_pos[lo : lo + _LOCI_CHUNK], dtype=segments.pos_dtype()
        )
        yield lo, np.asarray(
            _paint_chunk(
                seg_st, seg_hap, mut, founder_d[:, lo : lo + _LOCI_CHUNK], pos
            )
        )


def paint_chromosome(
    seg_st: jax.Array,  # (n, 2, S)
    seg_hap: jax.Array,
    mut: jax.Array,
    founder: np.ndarray,  # (H, m) uint8, concatenated over populations
    legend_pos: np.ndarray,  # (m,) int64
) -> np.ndarray:
    """(n, 2, m) uint8 simulated haplotypes, fully materialized (PED output
    and tests; the streaming writers use `paint_chunks`)."""
    return np.concatenate(
        [
            blk
            for _, blk in paint_chunks(
                seg_st, seg_hap, mut, founder, legend_pos
            )
        ],
        axis=2,
    )


def _load_founder_chr(sim, ic: int):
    """Concatenated founder panel + per-pop legends for one chromosome."""
    legends, panels = [], []
    for p in sim.pops:
        if p.vcf_addresses:
            v = vcf_io.read_vcf(p.vcf_addresses[ic][1])
            legends.append(v)
            panels.append(v.hap)
        else:
            _, hap_path, legend_path, _ = p.hap_addresses[ic]
            legends.append(hap_io.read_legend(legend_path))
            panels.append(hap_io.read_hap(hap_path))
    m0 = panels[0].shape[1]
    for pan in panels[1:]:
        if pan.shape[1] != m0:
            raise RuntimeError(
                "founder panels must have the same SNP count across "
                "populations for genotype output"
            )
    return legends, np.concatenate(panels, axis=0)


def _host_rows(sim, st) -> "np.ndarray | None":
    """Rows of this population this HOST writes: all of them in
    single-process runs (None = no slicing, reference-identical files);
    under `jax.distributed`, only the rows whose shards live on this
    host's devices — each host streams its own `.hostK.*` files
    (SURVEY §2.4 multi-host I/O row)."""
    from geneevolve_tpu.parallel import multihost

    if multihost.process_info()[1] == 1:
        return None
    ranges = multihost.host_row_ranges(st.seg_st, axis=1)
    rows = np.concatenate(
        [np.arange(lo, min(hi, st.n)) for lo, hi in ranges]
        or [np.arange(0)]
    )
    return rows


def save_genotypes(sim, gen: int) -> None:
    from geneevolve_tpu.parallel import multihost

    cfg = sim.cfg
    suffix = multihost.host_suffix()
    want_paint = cfg.out_hap or cfg.out_plink or cfg.out_plink01 or cfg.out_vcf
    if want_paint:
        for ic, chrom in enumerate(sim.chrs):
            legends, founder = _load_founder_chr(sim, ic)
            for p in sim.pops:
                st = p.state
                base = (
                    f"{cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
                    f"{suffix}"
                )
                leg = legends[p.index]
                pos = _legend_pos(leg)
                m = len(pos)
                rows = _host_rows(sim, st)

                # SNP-major formats (.hap, VCF) stream loci chunk by chunk:
                # paint on device, write, drop — peak host memory is one
                # (n, 2, chunk) block, never (n, 2, m)
                ids_out = st.ids if rows is None else st.ids[rows]
                n_out = len(ids_out)
                hap_f = None
                vcf_w = None
                if cfg.out_hap:
                    hap_f = open(base + ".hap", "wb")
                    hap_io.write_indv(base + ".indv", ids_out + 1)
                if cfg.out_vcf:
                    v = vcf_io.VcfData(
                        samples=[f"g{gen}_{i + 1}" for i in ids_out],
                        chrom=np.full(m, str(chrom), dtype=object),
                        pos=pos,
                        ids=_legend_ids(leg),
                        ref=_legend_al0(leg),
                        alt=_legend_al1(leg),
                        qual=np.full(m, ".", dtype=object),
                        filt=np.full(m, ".", dtype=object),
                        info=np.full(m, ".", dtype=object),
                        fmt=np.full(m, "GT", dtype=object),
                        hap=np.empty((0, 0), dtype=np.uint8),  # streamed
                        meta_lines=vcf_io.default_meta_lines(),
                    )
                    if isinstance(leg, vcf_io.VcfData):
                        v.chrom = leg.chrom
                        v.qual = leg.qual
                        v.filt = leg.filt
                    vcf_w = vcf_io.VcfStreamWriter(base + ".vcf", v)
                need_full = cfg.out_plink or cfg.out_plink01 or cfg.debug
                full_blocks = [] if need_full else None
                if hap_f or vcf_w or need_full:
                    if rows is None:
                        sel = (
                            st.seg_st[ic, : st.n], st.seg_hap[ic, : st.n],
                            st.mut[ic, : st.n],
                        )
                    else:
                        sel = (
                            st.seg_st[ic, rows], st.seg_hap[ic, rows],
                            st.mut[ic, rows],
                        )
                    for lo, blk in paint_chunks(*sel, founder, pos):
                        if hap_f is not None:
                            hap_f.write(
                                hap_io.hap_bytes(blk.reshape(n_out * 2, -1))
                            )
                        if vcf_w is not None:
                            vcf_w.write_block(lo, blk[:, 0], blk[:, 1])
                        if full_blocks is not None:
                            full_blocks.append(blk)
                if hap_f is not None:
                    hap_f.close()
                if vcf_w is not None:
                    vcf_w.close()
                if need_full:
                    painted = np.concatenate(full_blocks, axis=2)
                    del full_blocks
                    if cfg.debug:
                        # AF spot-check on the last SNPs
                        # (`Simulation.cpp:1368-1387`)
                        print("The last allele frequencies")
                        for af in painted[:, :, -10:].mean(axis=(0, 1)):
                            print(f"AF = {af:g}")
                if cfg.out_plink or cfg.out_plink01:
                    r = slice(None) if rows is None else rows
                    ids = plink_io.PedIds(
                        fid=st.ped["father"][r] + 1,  # FID = father (`Simulation.cpp:1396`)
                        iid=ids_out + 1,
                        pid=st.ped["father"][r] + 1,
                        mid=st.ped["mother"][r] + 1,
                        sex=st.sex[r],
                    )
                    geno = np.moveaxis(painted, 1, 2)  # (n, m, 2)
                    plink_io.write_ped_map(
                        base,
                        geno,
                        ids,
                        chrom,
                        _legend_ids(leg),
                        pos,
                        _legend_al0(leg),
                        _legend_al1(leg),
                        letters=cfg.out_plink,
                    )
    if cfg.out_interval:
        write_interval(sim, gen)


def _legend_pos(leg):
    return leg.pos


def _legend_ids(leg):
    return leg.ids


def _legend_al0(leg):
    return leg.ref if isinstance(leg, vcf_io.VcfData) else leg.al0


def _legend_al1(leg):
    return leg.alt if isinstance(leg, vcf_io.VcfData) else leg.al1


def _ascii_ints(x: np.ndarray):
    """Decimal ASCII of non-negative ints: a right-aligned (N, D) uint8
    digit matrix and the (N, D) mask of each value's significant digits."""
    x = np.asarray(x, dtype=np.int64).ravel()
    D = len(str(int(x.max()))) if x.size else 1
    digits = np.empty((x.size, D), dtype=np.uint8)
    v = x.copy()
    for j in range(D - 1, -1, -1):
        digits[:, j] = v % 10 + ord("0")
        v //= 10
    n_dig = np.ones(x.size, dtype=np.int64)
    for k in range(1, D):
        n_dig += x >= 10**k
    return digits, np.arange(D)[None, :] >= (D - n_dig)[:, None]


def _ascii_table(labels) -> tuple:
    """Left-aligned (H, L) uint8 matrix of byte strings and their lengths."""
    enc = [str(t).encode() for t in labels]
    L = max((len(e) for e in enc), default=1)
    mat = np.zeros((len(enc), L), dtype=np.uint8)
    for i, e in enumerate(enc):
        mat[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    return mat, np.array([len(e) for e in enc], dtype=np.int64)


def _join_lines(fields) -> bytes:
    """Space-separated, newline-terminated text lines from per-field
    (N, w) byte matrices and masks of the bytes that belong to the field."""
    n = fields[0][0].shape[0]
    mats, masks = [], []
    for k, (mat, mask) in enumerate(fields):
        sep = np.full((n, 1), ord(" ") if k < len(fields) - 1 else ord("\n"),
                      dtype=np.uint8)
        mats += [mat, sep]
        masks += [mask, np.ones((n, 1), dtype=bool)]
    return np.concatenate(mats, axis=1)[np.concatenate(masks, axis=1)].tobytes()


def _hap_labels(sim):
    """Per global founder hap: its 1-based index within its population,
    `gen0_indv` label (`<sample id>.<1|2>`) and 1-based root population."""
    local, labels, root = [], [], []
    for p in sim.pops:
        for h in range(2 * p.n_founders):
            local.append(h + 1)
            labels.append(f"{p.indv_ids[h // 2]}.{h % 2 + 1}")
            root.append(p.index + 1)
    return np.array(local), _ascii_table(labels), np.array(root)


def write_interval(sim, gen: int) -> None:
    """IBD ground-truth dump, schema per `ras_write_hap_to_interval_format`
    (`Simulation.cpp:1582-1639`): `h_ID chr hap st en hap_index gen0_indv
    root_pop`, 1-based IDs, gen0_indv = founder sample id + `.1/.2`.
    Rows are formatted as whole numpy byte matrices, a block of
    individuals at a time (a 300k-individual generation has ~10^8 rows).

    When `--out_interval` is set the engine runs meiosis with
    `merge_ibd=False` (`core/segments.py:meiose_one`), so the ledger keeps
    every crossover-split part boundary exactly like the reference's
    `recombine` (`Simulation.cpp:2903-2958`) — adjacent same-founder rows
    encode recombination-event positions and are NOT merged."""
    from concurrent.futures import ThreadPoolExecutor

    from geneevolve_tpu.parallel import multihost

    suffix = multihost.host_suffix()
    labels = _hap_labels(sim)
    jobs = []
    for p in sim.pops:
        rows = _host_rows(sim, p.state)
        rows = np.arange(p.state.n) if rows is None else np.asarray(rows)
        for ic, chrom in enumerate(sim.chrs):
            path = (
                f"{sim.cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
                f"{suffix}.int"
            )
            jobs.append((path, p, ic, chrom, rows))
    # one file per (population, chromosome); numpy releases the GIL on the
    # large array operations, so the files format in parallel
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for fut in [ex.submit(_write_int_file, *j, labels) for j in jobs]:
            fut.result()


def _write_int_file(path, p, ic, chrom, rows, labels) -> None:
    """One population's `.int` rows for chromosome `chrom`."""
    local, (lab_mat, lab_len), root = labels
    big = int(segments._big())
    st = p.state
    chr_end = p.maps[ic].chr_end
    chrom_b = np.frombuffer(str(chrom).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"h_ID chr hap st en hap_index gen0_indv root_pop\n")
        for lo in range(0, len(rows), _INT_ROWS):
            blk = rows[lo : lo + _INT_ROWS]
            with _DEVICE_READS:
                sts = np.asarray(st.seg_st[ic, blk]).astype(np.int64)
                haps = np.asarray(st.seg_hap[ic, blk]).astype(np.int64)
            k = (sts < big).sum(axis=-1, keepdims=True)
            slot = np.arange(sts.shape[-1])
            keep = slot < k  # (b, 2, S): the first k parts of each chromatid
            nxt = np.concatenate(
                [sts[..., 1:], np.zeros_like(sts[..., :1])], axis=-1
            )
            ens = np.where(slot + 1 < k, nxt, chr_end)
            hid = np.broadcast_to((st.ids[blk] + 1)[:, None, None], sts.shape)
            hap = np.broadcast_to(np.arange(2)[None, :, None], sts.shape)
            g = haps[keep]
            n_lines = len(g)
            f.write(_join_lines([
                _ascii_ints(hid[keep]),
                (np.broadcast_to(chrom_b, (n_lines, len(chrom_b))),
                 np.ones((n_lines, len(chrom_b)), dtype=bool)),
                _ascii_ints(hap[keep]),
                _ascii_ints(sts[keep]),
                _ascii_ints(ens[keep]),
                _ascii_ints(local[g]),
                (lab_mat[g],
                 np.arange(lab_mat.shape[1])[None, :] < lab_len[g][:, None]),
                _ascii_ints(root[g]),
            ]))


_INT_ROWS = 1 << 15  # individuals per formatted block of .int rows
# The writer threads read the ledger one at a time: on a sharded ledger
# each read is a program with collectives on every device, and programs
# launched from two threads at once can reach the devices in different
# orders, which deadlocks the collectives on GPUs.
_DEVICE_READS = threading.Lock()
