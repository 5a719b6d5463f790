"""Smoke run of both engines on one NVIDIA GPU, through the CLI.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # the --mesh paths on four cards only

Every phase writes its scenario with `tools/mkscenario.py` from `--seed`,
runs the real CLI (`geneevolve_tpu.cli.main`) in this process, and checks
the outputs against in-repo oracles:

1. segment engine at the largest row of the reference's Table 3.1:
   300,000 individuals, 22 chromosomes (~37 Morgans), 2,200 CVs, random
   mating, 3 generations, `.int` output at the last one;
2. determinism: phase 1 again with the same seed, byte-identical
   `.summary` and `.info` files;
3. paint path: chromosome 1 with a 14,588-SNP panel, `.hap` genotypes
   rebuilt from the `.int` intervals and the founder panel;
4. dense engine (`--backend dense`) on the full 22 x 14,588-SNP panel at
   100,000 individuals, one generation's meiosis checked against the
   host-side word-mask oracle;
5. kernels: the Triton meiosis kernel (`geneevolve_tpu/ops/`) against
   its XLA form at the phase 4 shape, bit for bit, with both device times,
   and end to end: s/gen of the dense engine loop with the kernel off and
   on.

`--four` runs the deme step's ring `ppermute` and matrix `all_to_all`
against the exchange recomputed from the migration-free step, phase 4
under `--mesh ind=2,loci=2` and phase 1 under `--mesh ind=4`, each
against its one-card run (byte-identical outputs); cheapest first.

Each phase prints its wall time, compile time (what the generations took
beyond the last one), steady-state s/gen (the last generation) and the
device's peak memory so far. The
last line of stdout is one JSON object naming the device; any failed check
raises, so the script exits non-zero and prints no such line. It refuses
to run unless JAX's first device is a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GIB = float(1 << 30)

# Table 3.1 shapes (BASELINE.md): 22 chromosomes x 14,588 SNPs = 320,936
# loci, 100 CVs per chromosome
D1 = dict(pop_size=300_000, n0=10_000, nchr=22, ncv=100, gens=3)
PAINT = dict(pop_size=3_000, n0=1_000, nchr=1, ncv=100, gens=2, snps=14_588)
DENSE = dict(pop_size=100_000, n0=1_000, nchr=22, ncv=100, gens=3,
             snps=14_588)


class SmokeError(AssertionError):
    """A check of the smoke run failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def peak_gib() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / GIB


# ----------------------------------------------------------------- running
def scenario(root: str, seed: int, shape: dict) -> list:
    """Write a mkscenario scenario; returns its CLI flags."""
    sys.path.insert(0, REPO)
    from tools.mkscenario import make_scenario

    flags = make_scenario(root, seed=seed, **shape)
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    return argv


def run_cli(argv: list, log_path: str) -> dict:
    """One `cli.main` run with its console log captured; returns its wall
    time and per-generation times."""
    from geneevolve_tpu import cli

    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            rc = cli.main(argv)
    except BaseException:
        print(open(log_path).read()[-4000:], file=sys.stderr)
        raise
    wall = time.perf_counter() - t0
    text = open(log_path).read()
    check(rc == 0, f"cli.main exited {rc}; log {log_path}")
    per_gen = [
        float(t) for t in re.findall(
            r"time used for this generation: ([0-9.]+) seconds", text
        )
    ]
    return {"wall": wall, "per_gen": per_gen}


def report(tag: str, r: dict) -> None:
    """Steady state is the last generation's time; compile time is what
    the earlier generations took beyond it (each new program shape
    compiles on its first generation)."""
    pg = r["per_gen"]
    steady = pg[-1]
    compile_s = sum(max(t - steady, 0.0) for t in pg[:-1])
    print(
        f"[{tag}] wall {r['wall']:.1f} s, compile {compile_s:.1f} s "
        f"(generations' time above the steady state), steady "
        f"{steady:.2f} s/gen, "
        f"per-generation {[round(t, 2) for t in pg]}, "
        f"peak device memory {peak_gib():.2f} GiB",
        flush=True,
    )


# ------------------------------------------------------------------ checks
def read_lines(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def check_sizes(prefix: str, n0: int, pop_size: int, gens: int) -> None:
    """Founders exact; every realized generation within 5 sigma of
    Poisson(pop_size) (the reference's per-couple Poisson law)."""
    for g in range(gens + 1):
        path = f"{prefix}.info.pop1.gen{g}.txt"
        lines = read_lines(path)
        check(lines[0].startswith("ID ID_Father ID_Mother"), f"{path} header")
        ncol = len(lines[0].split())
        check(all(len(ln.split()) == ncol for ln in lines[1:50]),
              f"{path} ragged rows")
        n = len(lines) - 1
        if g == 0:
            check(n == n0, f"gen 0 has {n} founders, want {n0}")
        else:
            check(abs(n - pop_size) <= 5 * np.sqrt(pop_size),
                  f"gen {g} size {n} outside 5 sigma of Poisson({pop_size})")


def summary_var_a(prefix: str) -> np.ndarray:
    lines = read_lines(f"{prefix}.pop1.summary")
    col = lines[0].split().index("ph1_var_A")
    return np.array([float(ln.split()[col]) for ln in lines[1:]])


def founder_var_a(root: str, nchr: int) -> float:
    """Gen-0 var(A) in float64 from the founder CV haplotypes and cv.info:
    A = sum_cv (t - 2p) a with t the founder's allele count and p the
    founders' allele frequency (`phenotype.additive_dominance_chr`, d = 0)."""
    from geneevolve_tpu.io import hap as hap_io

    info = np.loadtxt(os.path.join(root, "cv.info"), skiprows=1, ndmin=2)
    t, a = [], []
    for c in range(1, nchr + 1):
        h = hap_io.read_hap(os.path.join(root, f"cv.chr{c}.hap"))
        t.append(h[0::2].astype(np.float64) + h[1::2])
        a.append(info[info[:, 0] == c, 2])
    t = np.concatenate(t, axis=1)
    p = t.mean(axis=0) / 2.0
    A = (t - 2.0 * p) @ np.concatenate(a)
    return float(np.var(A, ddof=1))


def parse_int(path: str) -> dict:
    """Numeric columns of an `.int` file: h_ID, hap, st, en, hap_index."""
    with open(path) as f:
        head = f.readline().split()
    check(head == ["h_ID", "chr", "hap", "st", "en", "hap_index",
                   "gen0_indv", "root_pop"], f"{path} header")
    tab = np.loadtxt(path, skiprows=1, usecols=(0, 2, 3, 4, 5),
                     dtype=np.int64, ndmin=2)
    return dict(zip(("h_ID", "hap", "st", "en", "hap_index"), tab.T))


def check_int_chain(path: str, chr_end: int) -> dict:
    """`.int` rows chain: within one chromatid, parts are sorted, `en` of a
    row is `st` of the next, the first starts at 0 and the last ends at the
    map's end. (A crossover in the map's last bin lands up to one bin width
    past its end, as in the reference, so a last part may start there.)"""
    c = parse_int(path)
    key = c["h_ID"] * 2 + c["hap"]
    same = key[1:] == key[:-1]
    check(np.all(c["en"][:-1][same] == c["st"][1:][same]),
          f"{path}: rows do not chain")
    first = np.concatenate([[True], ~same])
    last = np.concatenate([~same, [True]])
    check(np.all(c["st"][first] == 0), f"{path}: chromatid not starting at 0")
    check(np.all(c["en"][last] == chr_end), f"{path}: chromatid not ending "
          f"at {chr_end}")
    check(np.all(c["st"][1:][same] >= c["st"][:-1][same]),
          f"{path}: unsorted parts")
    return c


def check_int_files(prefix: str, gen: int, nchr: int, full_chr: int) -> None:
    """Every `.int` file has the header and 8 columns per row; chromosome
    `full_chr` is checked row by row."""
    from tools.mkscenario import CHR_MB

    for c in range(1, nchr + 1):
        path = f"{prefix}.pop1.gen{gen}.chr{c}.int"
        with open(path) as f:
            head = [f.readline() for _ in range(1000)]
        check(head[0].split()[0] == "h_ID", f"{path} header")
        check(all(len(ln.split()) == 8 for ln in head[1:] if ln),
              f"{path} malformed rows")
    map_end = (CHR_MB[full_chr - 1] * 1_000_000 // 50_000) * 50_000
    check_int_chain(f"{prefix}.pop1.gen{gen}.chr{full_chr}.int", map_end)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def output_digests(prefix: str) -> dict:
    """sha256 of every output file of a run, keyed by its suffix."""
    return {p[len(prefix):]: sha256(p) for p in sorted(glob.glob(prefix + ".*"))
            if not p.endswith(".log")}


def compare_outputs(want: dict, got: dict, what: str) -> None:
    check(want.keys() == got.keys(), f"{what}: file sets differ: "
          f"{sorted(set(want) ^ set(got))}")
    bad = [k for k in want if want[k] != got[k]]
    check(not bad, f"{what}: files differ: {bad}")


# ------------------------------------------------------------------ phases
def phase_segment(work: str, seed: int, shape: dict, mesh: str = "",
                  tag: str = "phase 1 segment") -> dict:
    """Phase 1 (and its mesh twin): run, check, return file digests."""
    root = os.path.join(work, "d1")
    if not os.path.exists(os.path.join(root, "cv.info")):
        scenario(root, seed, shape)
    argv = scenario_flags(root)
    prefix = os.path.join(work, f"seg{mesh.replace('=', '').replace(',', '')}")
    extra = ["--mesh", mesh] if mesh else []
    r = run_cli(argv + ["--seed", str(seed), "--prefix", prefix, "--RM",
                        "--out_interval", *extra], prefix + ".log")
    report(tag, r)
    check(len(r["per_gen"]) == shape["gens"], "missing generations in log")
    check_sizes(prefix, shape["n0"], shape["pop_size"], shape["gens"])
    var_a = summary_var_a(prefix)
    want = founder_var_a(root, shape["nchr"])
    check(np.isfinite(var_a).all(), "non-finite var_A in summary")
    check(abs(var_a[0] - want) <= 1e-4 * abs(want),
          f"gen-0 var_A {var_a[0]} != float64 oracle {want} (rtol 1e-4)")
    check_int_files(prefix, shape["gens"], shape["nchr"], shape["nchr"])
    digests = output_digests(prefix)
    for p in glob.glob(prefix + ".pop1.gen*.int"):
        os.remove(p)  # ~4 GB at full scale; the digests stay
    return {"digests": digests, "var_a0": var_a[0], "oracle": want}


def scenario_flags(root: str) -> list:
    names = {"file_gen_info": "popinfo.txt", "file_hap_name": "hap_address.txt",
             "file_recom_map": "rmap.txt", "file_cv_info": "cv.info",
             "file_cvs": "cv_address.txt"}
    argv = []
    for k, v in names.items():
        argv += [f"--{k}", os.path.join(root, v)]
    return argv


def phase_determinism(work: str, seed: int, shape: dict, first: dict) -> None:
    """Phase 2: the same run again (warm compile cache) must reproduce
    `.summary` and `.info` byte for byte."""
    again = phase_segment(work, seed, shape, tag="phase 2 determinism")
    keep = lambda d: {k: v for k, v in d.items()
                      if k.endswith(".summary") or ".info." in k}
    compare_outputs(keep(first["digests"]), keep(again["digests"]),
                    "same-seed rerun")
    print("[phase 2 determinism] .summary and .info byte-identical",
          flush=True)


def phase_paint(work: str, seed: int, shape: dict, n_check: int = 50) -> None:
    """Phase 3: `.hap` genotypes equal the founder panel painted through
    the `.int` intervals, for `n_check` random chromatids."""
    from geneevolve_tpu.io import hap as hap_io

    root = os.path.join(work, "paint")
    argv = scenario(root, seed, shape)
    prefix = os.path.join(work, "paint_out")
    r = run_cli(argv + ["--seed", str(seed), "--prefix", prefix,
                        "--out_hap", "--out_plink", "--out_interval"],
                prefix + ".log")
    report("phase 3 paint", r)
    g = shape["gens"]
    base = f"{prefix}.pop1.gen{g}.chr1"
    panel = hap_io.read_hap(os.path.join(root, "ref.chr1.hap"))  # (2n0, m)
    pos = hap_io.read_legend(os.path.join(root, "ref.chr1.legend")).pos
    out = hap_io.read_hap(base + ".hap")  # (2n, m)
    ids = np.array([int(x) for x in hap_io.read_indv(base + ".indv")])
    check(out.shape == (2 * len(ids), len(pos)), f"{base}.hap shape")
    c = parse_int(base + ".int")
    rng = np.random.default_rng(seed)
    row_of = {v: i for i, v in enumerate(ids)}
    for k in rng.choice(2 * len(ids), size=min(n_check, 2 * len(ids)),
                        replace=False):
        hid, h = int(ids[k // 2]), int(k % 2)
        sel = (c["h_ID"] == hid) & (c["hap"] == h)
        sts, src = c["st"][sel], c["hap_index"][sel] - 1
        seg = np.searchsorted(sts, pos, side="right") - 1
        want = panel[src[seg], np.arange(len(pos))]
        got = out[2 * row_of[hid] + h]
        check(np.array_equal(got, want),
              f"chromatid {hid}.{h}: .hap differs from the .int painting")
    n = len(ids)
    check(len(read_lines(base + ".ped")) == n, f"{base}.ped rows")
    check(len(read_lines(base + ".map")) == len(pos), f"{base}.map rows")
    print(f"[phase 3 paint] {n_check} chromatids of {len(pos)} SNPs match "
          "the .int painting exactly", flush=True)


@contextlib.contextmanager
def record_reproduce(gen: int, rows: int):
    """Capture generation `gen`'s dense meiosis inputs and output for the
    first `rows` children, and its child CV matrix (copied to the host)."""
    from geneevolve_tpu.dense import backend

    orig, orig_cv = backend._reproduce_planes, backend._child_cv
    calls, rec = [], {}

    def wrapped(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu, cfg,
                **kw):
        out = orig(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu, cfg=cfg,
                   **kw)
        calls.append(None)
        if len(calls) == gen:
            f, m = fathers[:rows], mothers[:rows]
            host = lambda x: None if x is None else np.asarray(x[:rows])
            rec.update(
                par=np.asarray(hap[np.concatenate([f, m])]),
                xo_p=host(xo_p), st_p=host(st_p), xo_m=host(xo_m),
                st_m=host(st_m), mu=host(mu), child=host(out), cfg=cfg,
            )
        return out

    def wrapped_cv(*args, chr_len):
        out = orig_cv(*args, chr_len=chr_len)
        if len(calls) == gen and "cv" not in rec:
            rec["cv"] = np.asarray(out)
        return out

    backend._reproduce_planes, backend._child_cv = wrapped, wrapped_cv
    try:
        yield rec
    finally:
        backend._reproduce_planes, backend._child_cv = orig, orig_cv


def check_reproduce_on_host(rec: dict) -> None:
    """The recorded children equal `meiose_packed_xla` +
    `apply_mutations_packed` evaluated on the host's CPU device."""
    import dataclasses

    import jax

    from geneevolve_tpu.dense import packed as pk

    r = len(rec["child"])
    cfg = dataclasses.replace(rec["cfg"], n=r)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        par = jax.device_put(rec["par"], cpu)
        fi = np.arange(r, dtype=np.int32)
        a = pk.meiose_packed_xla(par, fi, rec["xo_p"], rec["st_p"], cfg)
        b = pk.meiose_packed_xla(par, fi + r, rec["xo_m"], rec["st_m"], cfg)
        if rec["mu"] is not None:
            a = pk.apply_mutations_packed(a, rec["mu"][:, 0])
            b = pk.apply_mutations_packed(b, rec["mu"][:, 1])
        want = np.stack([np.asarray(a), np.asarray(b)], axis=1)
    check(np.array_equal(rec["child"], want),
          "dense meiosis on the card differs from the host oracle")


def check_phenotype_precision(cv_host: np.ndarray, eff: np.ndarray) -> float:
    """`phenotype_from_cv` on the default device against float64 numpy:
    max |error| <= 1e-5 * max |value| (a TF32 product misses this by ~100x).
    Returns the relative error."""
    import jax.numpy as jnp

    from geneevolve_tpu.dense.packed import phenotype_from_cv

    got = np.asarray(phenotype_from_cv(jnp.asarray(cv_host), jnp.asarray(eff)))
    t = cv_host[:, 0].astype(np.float64) + cv_host[:, 1]
    want = (t - t.mean(axis=0)) @ eff.astype(np.float64)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    check(err <= 1e-5, f"phenotype product rel. error {err:.2e} > 1e-5")
    return err


def phase_dense(work: str, seed: int, shape: dict, mesh: str = "",
                tag: str = "phase 4 dense", oracle: bool = True) -> dict:
    """Phase 4 (and its mesh twin): the dense engine on the full panel."""
    import jax

    root = os.path.join(work, "dense")
    if not os.path.exists(os.path.join(root, "cv.info")):
        scenario(root, seed, shape)
    argv = scenario_flags(root)
    prefix = os.path.join(work, f"dense{mesh.replace('=', '').replace(',', '')}")
    n_pad = shape["pop_size"] + 4 * int(np.sqrt(shape["pop_size"])) + 16
    mw = shape["nchr"] * (-(-shape["snps"] // 32))
    state_b = n_pad * 2 * mw * 4
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    print(f"[{tag}] packed state {state_b / GIB:.2f} GiB, parents + children "
          f"{2 * state_b / GIB:.2f} GiB of a {limit / GIB:.2f} GiB device "
          "limit", flush=True)
    extra = ["--mesh", mesh] if mesh else []
    with record_reproduce(gen=2, rows=64) as rec:
        r = run_cli(argv + ["--seed", str(seed), "--prefix", prefix,
                            "--backend", "dense", "--RM", *extra],
                    prefix + ".log")
    report(tag, r)
    check_sizes(prefix, shape["n0"], shape["pop_size"], shape["gens"])
    check(np.isfinite(summary_var_a(prefix)).all(), "non-finite var_A")
    if oracle:
        check_reproduce_on_host(rec)
        info = np.loadtxt(os.path.join(root, "cv.info"), skiprows=1, ndmin=2)
        err = check_phenotype_precision(
            rec["cv"], info[:, 2].astype(np.float32)
        )
        print(f"[{tag}] 64 children match the host word-mask oracle "
              f"exactly; phenotype product rel. error {err:.1e} vs float64",
              flush=True)
    return {"digests": output_digests(prefix)}


def phase_deme(n: int, snps: int, nchr: int, ind: int, seed: int) -> None:
    """Deme step over an (ind, 1) mesh at the dense phase's widths: ring
    `ppermute` and matrix `all_to_all` migrations equal the exchange
    recomputed from the migration-free step."""
    import jax
    import jax.numpy as jnp

    from geneevolve_tpu.dense.packed import PackedConfig, init_state_streamed
    from geneevolve_tpu.parallel import make_deme_step, make_mesh, shard_state

    chr_len = -(-snps // 32) * 32
    cfg = PackedConfig(n=n, m=nchr * chr_len, n_chr=nchr, xo_cap=16,
                       mut_rate=1.0, mut_cap=8, ncv=2200, selection=False)
    mesh = make_mesh(jax.devices()[:ind], (ind, 1))
    state = shard_state(init_state_streamed(jax.random.key(seed), cfg), mesh)
    key = jax.random.key(seed + 1)
    n_loc = n // ind
    perms = [
        np.asarray(jax.random.permutation(
            jax.random.split(jax.random.fold_in(key, i))[1], n_loc))
        for i in range(ind)
    ]
    t0 = time.perf_counter()
    base = jax.block_until_ready(make_deme_step(cfg, mesh)(state, key))
    n_emig = int(round(0.1 * n_loc))
    ring = jax.block_until_ready(
        make_deme_step(cfg, mesh, mig_rate=0.1)(state, key))
    dst = np.concatenate([i * n_loc + perms[i][:n_emig] for i in range(ind)])
    src = np.concatenate([((i - 1) % ind) * n_loc + perms[(i - 1) % ind][:n_emig]
                          for i in range(ind)])
    _check_exchange(base, ring, dst, src, "ring ppermute")
    M = np.full((ind, ind), 0.3 / (ind - 1))
    np.fill_diagonal(M, 0.7)
    counts = np.round(M * n_loc).astype(np.int64)
    np.fill_diagonal(counts, 0)
    send_off = np.cumsum(counts, axis=1) - counts
    recv_off = np.cumsum(counts, axis=0) - counts
    mat = jax.block_until_ready(
        make_deme_step(cfg, mesh, mig_matrix=M)(state, key))
    dst, src = [], []
    for i in range(ind):  # receiver
        for d in range(ind):  # sender
            k = np.arange(counts[d, i])
            dst.append(i * n_loc + perms[i][recv_off[d, i] + k])
            src.append(d * n_loc + perms[d][send_off[d, i] + k])
    _check_exchange(base, mat, np.concatenate(dst), np.concatenate(src),
                    "matrix all_to_all")
    print(f"[four deme] n={n} m={cfg.m} mesh=({ind}, 1): ring ppermute and "
          f"matrix all_to_all exchanges exact; three steps incl. compile "
          f"{time.perf_counter() - t0:.1f} s, peak device memory "
          f"{peak_gib():.2f} GiB", flush=True)


def _check_exchange(base: dict, got: dict, dst, src, what: str) -> None:
    import jax.numpy as jnp

    for k in ("hap", "cv"):
        b = base[k]
        want = b.at[jnp.asarray(dst)].set(b[jnp.asarray(src)])
        check(bool(jnp.array_equal(want, got[k])),
              f"{what}: {k} differs from the recomputed exchange")


def engine_ab(argv: list, work: str) -> dict:
    """Steady-state s/gen of the dense engine loop with the GPU kernel off,
    on, on, off (so clock drift cancels); every run must write the same
    `.summary` and `.info` bytes. Generation 1 of each run is left out."""
    from geneevolve_tpu.config import parse_args
    from geneevolve_tpu.dense.backend import DenseSimulation

    times = {False: [], True: []}
    digests = set()
    for i, kernels in enumerate((False, True, True, False)):
        prefix = os.path.join(work, f"ab_dense{i}")
        cfg = parse_args(argv + ["--prefix", prefix])
        sim = DenseSimulation(cfg, verbose=False)
        sim.kernels = kernels
        sim.init_generation0()
        for g in range(1, sim.tot_gen + 1):
            t0 = time.perf_counter()
            sim.step(g)
            if g > 1:
                times[kernels].append(time.perf_counter() - t0)
        sim.write_summary()
        digests.add(tuple(output_digests(prefix).values()))
        for p in glob.glob(prefix + ".*"):
            os.remove(p)
    check(len(digests) == 1, "dense engine: outputs differ with the "
          "kernel on/off")
    return {k: float(np.median(v)) for k, v in times.items()}


def phase_kernels(work: str, seed: int, dense: dict) -> None:
    """Phase 5: the Triton meiosis kernel against its XLA form on the card
    — the stage at the phase 4 shape (bit-equal outputs, both device
    times), then end to end (s/gen of the dense engine loop, same
    outputs)."""
    sys.path.insert(0, REPO)
    from tools import stage_roofline as sr

    copy_bps = sr.copy_rate(1 << 30)
    rows = sr.dense_stages(dense["pop_size"], dense["snps"], dense["nchr"],
                           copy_bps)
    for r in rows:
        print(f"[phase 5 kernels] {r['stage']}: {1e3 * r['seconds']:.2f} ms, "
              f"{r['GBps']:.0f} GB/s ({r['pct_of_3.35TBps']:.1f} % of "
              "3.35 TB/s); bit-equal to the XLA form", flush=True)
    argv = scenario_flags(os.path.join(work, "dense")) + [
        "--seed", str(seed), "--RM", "--backend", "dense"]
    t = engine_ab(argv, work)
    print(f"[phase 5 kernels] packed meiosis (dense engine) end to end: "
          f"{t[False]:.4f} s/gen XLA, {t[True]:.4f} s/gen kernel "
          f"({t[False] / t[True]:.3f}x); outputs identical", flush=True)


# -------------------------------------------------------------------- main
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out


def run_one_card(work: str, seed: int) -> None:
    first = phase_segment(work, seed, D1)
    print(f"[phase 1 segment] gen-0 var_A {first['var_a0']:g} vs float64 "
          f"oracle {first['oracle']:.6g}; sizes, .info and .int checked",
          flush=True)
    phase_determinism(work, seed, D1, first)
    phase_paint(work, seed, PAINT)
    phase_dense(work, seed, DENSE)
    phase_kernels(work, seed, DENSE)


def run_four(work: str, seed: int, seg: dict = D1,
             dense: dict = DENSE) -> None:
    """Cheapest comparison first, so a cut run still reports the others."""
    phase_deme(dense["pop_size"], dense["snps"], dense["nchr"], 4, seed)
    one = phase_dense(work, seed, dense, tag="four: phase 4 one card",
                      oracle=False)
    four = phase_dense(work, seed, dense, mesh="ind=2,loci=2",
                       tag="four: phase 4 --mesh ind=2,loci=2", oracle=False)
    compare_outputs(one["digests"], four["digests"], "--mesh ind=2,loci=2")
    print("[four] phase 4 --mesh ind=2,loci=2 outputs byte-identical to the "
          "one-card run", flush=True)
    one = phase_segment(work, seed, seg, tag="four: phase 1 one card")
    four = phase_segment(work, seed, seg, mesh="ind=4",
                         tag="four: phase 1 --mesh ind=4")
    compare_outputs(one["digests"], four["digests"], "--mesh ind=4")
    print("[four] phase 1 --mesh ind=4 outputs (.summary, .info, .int) "
          "byte-identical to the one-card run", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card --mesh paths")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 1
    if args.four and len(devs) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import geneevolve_tpu  # noqa: F401  (fails outside a checkout)

    sys.stdout.reconfigure(line_buffering=True)  # progress shows as it runs

    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        (run_four if args.four else run_one_card)(work, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
