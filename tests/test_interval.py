""".int (IBD interval) output fidelity vs the reference's part structure
(`ras_write_hap_to_interval_format`, Simulation.cpp:1582-1639).

With --out_interval the engine keeps crossover-split part boundaries
(merge_ibd=False), so the .int file reconstructs recombination history:
at generation 1 every parent is a founder whose chromatids are single
full-chromosome parts, hence each gamete's part count minus one IS its
crossover count, and consecutive parts must alternate between the two
chromatids of a single founder.
"""

import collections
from pathlib import Path

import numpy as np
import pytest

from geneevolve_tpu.config import parse_args
from geneevolve_tpu.core.engine import Simulation


@pytest.fixture(scope="module")
def gen1_run(tmp_path_factory):
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from tools.mkscenario import make_scenario

    root = tmp_path_factory.mktemp("int_scenario")
    flags = make_scenario(
        str(root), n0=40, pop_size=200, gens=1, nchr=2, ncv=10, seed=3
    )
    out = tmp_path_factory.mktemp("int_out")
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    argv += [
        "--seed", "99", "--prefix", str(out / "o"), "--out_interval",
    ]
    cfg = parse_args(argv)
    sim = Simulation(cfg, verbose=False)
    sim.run()
    return sim, out


def _read_int(path):
    rows = []
    with open(path) as f:
        hdr = f.readline().split()
        for line in f:
            t = line.split()
            rows.append(
                {
                    "h_ID": int(t[0]),
                    "hap": int(t[2]),
                    "st": int(t[3]),
                    "en": int(t[4]),
                    "hap_index": int(t[5]),
                    "gen0_indv": t[6],
                    "root_pop": int(t[7]),
                }
            )
    assert hdr == [
        "h_ID", "chr", "hap", "st", "en", "hap_index", "gen0_indv",
        "root_pop",
    ]
    return rows


def test_int_gen1_reconstructs_crossovers(gen1_run):
    sim, out = gen1_run
    p = sim.pops[0]
    total_xo, total_gam = 0, 0
    for ic, chrom in enumerate(sim.chrs):
        rows = _read_int(out / f"o.pop1.gen1.chr{chrom}.int")
        by_gam = collections.defaultdict(list)
        for r in rows:
            by_gam[(r["h_ID"], r["hap"])].append(r)
        assert len(by_gam) == 2 * p.state.n
        L = p.maps[ic].xo_lambda  # Morgans for this chromosome
        for (hid, hap), segs in by_gam.items():
            # rows chain: st[0] = chr start, en[k] = st[k+1], en[-1] = chr end
            assert segs[0]["st"] == p.maps[ic].chr_start
            assert segs[-1]["en"] == p.maps[ic].chr_end
            for a, b in zip(segs, segs[1:]):
                assert a["en"] == b["st"]
            # gen-1 structure: all parts from ONE founder, alternating
            # chromatids (parents are founders = single full-chr parts, so
            # every boundary is a crossover, reference recombine semantics)
            founder = {(s["hap_index"] - 1) // 2 for s in segs}
            assert len(founder) == 1
            chromatids = [(s["hap_index"] - 1) % 2 for s in segs]
            for a, b in zip(chromatids, chromatids[1:]):
                assert a != b, "crossover-split boundary was merged away"
            # gen0_indv carries the founder sample id + .1/.2 suffix
            for s in segs:
                base, suf = s["gen0_indv"].rsplit(".", 1)
                assert suf == str((s["hap_index"] - 1) % 2 + 1)
                assert base == p.indv_ids[(s["hap_index"] - 1) // 2]
            total_xo += len(segs) - 1
            total_gam += 1
        # per-chromosome crossover mean matches the sampler's law
        n_gam = 2 * p.state.n
        xo_chr = sum(len(v) - 1 for v in by_gam.values())
        mean = xo_chr / n_gam
        tol = 5 * np.sqrt(L / n_gam)  # 5 sigma of the Poisson mean
        assert abs(mean - L) < tol, (chrom, mean, L, tol)


def test_split_ledger_paints_identically_to_merged(tmp_path, mini_scenario):
    """merge_ibd only affects .int granularity, never painted genotypes."""
    outs = {}
    for mode, extra in (("merged", []), ("split", ["--out_interval"])):
        d = tmp_path / mode
        d.mkdir()
        argv = [
            "--file_gen_info", str(mini_scenario / "popinfo.txt"),
            "--file_hap_name", str(mini_scenario / "hap_address.txt"),
            "--file_recom_map", str(mini_scenario / "rmap.txt"),
            "--file_cv_info", str(mini_scenario / "cv.info"),
            "--file_cvs", str(mini_scenario / "cv_address.txt"),
            "--seed", "777", "--prefix", str(d / "out"), "--out_hap",
            *extra,
        ]
        sim = Simulation(parse_args(argv), verbose=False)
        sim.run()
        outs[mode] = d
    for chrom in (1, 2):
        a = (outs["merged"] / f"out.pop1.gen4.chr{chrom}.hap").read_bytes()
        b = (outs["split"] / f"out.pop1.gen4.chr{chrom}.hap").read_bytes()
        assert a == b
    # the split run's summary trajectories are also unchanged
    assert (outs["merged"] / "out.pop1.summary").read_text() == (
        outs["split"] / "out.pop1.summary"
    ).read_text()


def _write_interval_row_loop(sim, gen, path_of):
    """The per-row writer the vectorized `output.write_interval` replaced,
    kept as its reference."""
    from geneevolve_tpu.core import segments

    offsets = np.array([p.hap_offset for p in sim.pops])
    big = int(segments._big())
    for p in sim.pops:
        st = p.state
        for ic, chrom in enumerate(sim.chrs):
            seg_st = np.asarray(st.seg_st[ic])
            seg_hap = np.asarray(st.seg_hap[ic])
            with open(path_of(p, chrom), "w") as f:
                f.write("h_ID chr hap st en hap_index gen0_indv root_pop\n")
                for i in range(st.n):
                    for h in range(2):
                        sts = seg_st[i, h]
                        k = int((sts < big).sum())
                        ens = np.append(sts[1:k], p.maps[ic].chr_end)
                        for s in range(k):
                            ghap = int(seg_hap[i, h, s])
                            rp = int(np.searchsorted(offsets, ghap, "right") - 1)
                            local = ghap - offsets[rp]
                            indv = sim.pops[rp].indv_ids[local // 2]
                            f.write(
                                f"{st.ids[i] + 1} {chrom} {h} {sts[s]} "
                                f"{ens[s]} {local + 1} {indv}.{local % 2 + 1} "
                                f"{rp + 1}\n"
                            )


def test_interval_writer_matches_row_loop(gen1_run, tmp_path, monkeypatch):
    """The block-formatted .int writer is byte-identical to the per-row
    loop, including across block boundaries."""
    from geneevolve_tpu.core import output

    sim, out = gen1_run
    monkeypatch.setattr(output, "_INT_ROWS", 7)  # several blocks per chr
    monkeypatch.setattr(sim.cfg, "prefix", str(tmp_path / "v"))
    output.write_interval(sim, 1)
    _write_interval_row_loop(
        sim, 1, lambda p, c: tmp_path / f"ref.pop{p.index + 1}.chr{c}.int"
    )
    for c in sim.chrs:
        got = (tmp_path / f"v.pop1.gen1.chr{c}.int").read_bytes()
        want = (tmp_path / f"ref.pop1.chr{c}.int").read_bytes()
        assert got == want
        assert got == (out / f"o.pop1.gen1.chr{c}.int").read_bytes()


def test_interval_writer_reads_ledger_one_thread_at_a_time(
    gen1_run, tmp_path, monkeypatch
):
    """The writer threads never read the device ledger at the same time (on
    a sharded ledger each read is a program with collectives, and launches
    from two threads at once can deadlock them); the files are unchanged."""
    import dataclasses
    import threading
    import time

    from geneevolve_tpu.core import output

    sim, out = gen1_run
    p = sim.pops[0]
    lock, active, most = threading.Lock(), [0], [0]

    class Metered:
        def __init__(self, arr):
            self.arr = arr

        def __getitem__(self, idx):
            with lock:
                active[0] += 1
                most[0] = max(most[0], active[0])
            time.sleep(0.005)  # widen the window two readers could share
            try:
                return self.arr[idx]
            finally:
                with lock:
                    active[0] -= 1

    st = dataclasses.replace(p.state, seg_st=Metered(p.state.seg_st),
                             seg_hap=Metered(p.state.seg_hap))
    monkeypatch.setattr(p, "state", st)
    monkeypatch.setattr(output, "_INT_ROWS", 7)
    monkeypatch.setattr(sim.cfg, "prefix", str(tmp_path / "m"))
    output.write_interval(sim, 1)
    assert most[0] == 1
    for c in sim.chrs:
        assert (tmp_path / f"m.pop1.gen1.chr{c}.int").read_bytes() == (
            out / f"o.pop1.gen1.chr{c}.int").read_bytes()
