"""A/B parity harness: run the reference GeneEvolve binary and this
framework on the bundled Example scenarios (Examples.zip: Example1..10, plus
the Example2.zip 22-chromosome VCF scenario as id "vcf") and compare
variance-component trajectories distributionally.

The reference's own validation is statistical (PDF sections 3.2-3.5): RNGs
differ, so gen-0 deterministic quantities must match tightly while
trajectories must agree in distribution. Checks per example:

  - gen-0 var_A / var_D: deterministic given the founder panel and CV
    effects (`Simulation.cpp:2624-2749`) -> relative tolerance 2%
    (the binary prints 6 significant digits).
  - gen-0 var_E: both implementations rescale E to the target ve exactly
    (`Simulation.cpp:3166-3180`) -> 2%.
  - trajectory means over generations 1..G of var_A, var_P, h2: drift and
    mating noise -> 15% relative (h2 absolute 0.05).

Version skew note (SURVEY.md section 2.2): the shipped binary is v1.1.0 and
rejects the `--no_output` flag that 8 of the 10 example scripts pass
(`src/parameters.cpp:146-150` has no such flag in any source version), so
that flag is stripped from the argv given to the binary; our parser accepts
it for drop-in compatibility.

Usage:
  python tools/parity.py [--examples DIR] [--ref-bin PATH] [--only 1,2,vcf]
                         [--out PARITY.json]

Exits nonzero if any check fails; prints one table per example and writes a
JSON report.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import tempfile
import traceback
import zipfile

# Example-scale runs are tiny and this harness compares against a CPU
# binary, so it runs on the CPU backend (override with GE_PARITY_PLATFORM).
# Forced through the config API too, before any backend initializes, so a
# pre-set JAX_PLATFORMS cannot win (same as tests/conftest.py).
_platform = os.environ.get("GE_PARITY_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform

import jax

jax.config.update("jax_platforms", _platform)

import numpy as np

try:
    import geneevolve_tpu  # noqa: F401  (installed package)
except ImportError:  # fall back to running from a source checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_REF_BIN = "/root/reference/GeneEvolve_Linux"
DEFAULT_ZIP = "/root/reference/Examples.zip"
DEFAULT_VCF_ZIP = "/root/reference/Example2.zip"


def parse_example_script(path: str) -> list:
    """Flag list from an ExampleN.sh (strips the binary and backslashes)."""
    toks = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip("\\").strip()
            if not line or line.startswith("#"):
                continue
            toks.extend(shlex.split(line))
    # drop the leading ../bin/GeneEvolve
    return [t for t in toks if not t.endswith("GeneEvolve")]


def with_prefix(argv: list, prefix: str) -> list:
    out = list(argv)
    i = out.index("--prefix")
    out[i + 1] = prefix
    return out


def with_seed(argv: list, seed: int) -> list:
    out = list(argv)
    i = out.index("--seed")
    out[i + 1] = str(seed)
    return out


def mean_summaries(paths: list) -> dict:
    """Elementwise seed-average of several .summary files (same schedule →
    same row count; trajectory-mean noise shrinks ~1/sqrt(seeds), so the
    averaged comparison runs at proportionally tighter tolerances)."""
    all_cols = [read_summary(p) for p in paths]
    return {
        k: np.mean([c[k] for c in all_cols], axis=0) for k in all_cols[0]
    }


def for_ref_binary(argv: list) -> list:
    """Strip flags the shipped v1.1.0 binary does not know."""
    return [a for a in argv if a != "--no_output"]


def read_summary(path: str) -> dict:
    """{column: (G+1,) float array} from a .summary file (either schema)."""
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    cols = {h: np.array([float(r[i]) for r in rows]) for i, h in enumerate(header)}
    return cols


def find_col(cols: dict, *cands) -> np.ndarray:
    for c in cands:
        if c in cols:
            return cols[c]
    for name in cols:
        for c in cands:
            if name.lower().endswith(c.lower()):
                return cols[name]
    raise KeyError(f"none of {cands} in {list(cols)}")


def compare(ref: dict, ours: dict, n_pheno: int = 1,
            traj_scale: float = 1.0) -> list:
    """[(name, ref_val, our_val, tol, ok)]. `traj_scale` tightens the
    trajectory tolerances for seed-averaged comparisons (gen-0 checks are
    deterministic given the panel, so their tolerance never scales)."""
    checks = []
    traj_tol = round(0.15 * traj_scale, 4)
    h2_tol = round(0.05 * traj_scale, 4)

    def rel(name, r, o, tol):
        denom = max(abs(r), 1e-9)
        checks.append((name, float(r), float(o), tol, bool(abs(o - r) / denom <= tol)))

    for j in range(1, n_pheno + 1):
        tag = f"ph{j} " if n_pheno > 1 else ""
        for comp, tol0 in (("var_A", 0.02), ("var_D", 0.02), ("var_E", 0.02)):
            try:
                r = find_col(ref, f"ph{j}_{comp}", comp)
                o = find_col(ours, f"ph{j}_{comp}", comp)
            except KeyError:
                continue
            if abs(r[0]) < 1e-12 and abs(o[0]) < 1e-12:
                checks.append((f"{tag}gen0 {comp}", float(r[0]), float(o[0]), tol0, True))
            else:
                rel(f"{tag}gen0 {comp}", r[0], o[0], tol0)
            if comp == "var_A":
                rel(f"{tag}mean {comp} g1..G", float(np.mean(r[1:])),
                    float(np.mean(o[1:])), traj_tol)
        try:
            r = find_col(ref, f"ph{j}_var_P", "var_P")
            o = find_col(ours, f"ph{j}_var_P", "var_P")
            rel(f"{tag}mean var_P g1..G", float(np.mean(r[1:])),
                float(np.mean(o[1:])), traj_tol)
            rh = find_col(ref, f"ph{j}_h2", "h2")
            oh = find_col(ours, f"ph{j}_h2", "h2")
            dh = abs(float(np.mean(rh[1:])) - float(np.mean(oh[1:])))
            checks.append((f"{tag}mean h2 g1..G", float(np.mean(rh[1:])),
                           float(np.mean(oh[1:])), h2_tol, bool(dh <= h2_tol)))
        except KeyError:
            pass
    return checks


def print_checks(pop: int, checks: list) -> bool:
    ok = True
    print(f"  pop {pop}:")
    for name, r, o, tol, good in checks:
        mark = "ok  " if good else "FAIL"
        print(f"    [{mark}] {name:<24s} ref={r:<12.5g} ours={o:<12.5g} "
              f"tol={tol:g}")
        ok &= good
    return ok


OURS_EXTRA: list = []  # extra flags appended to OUR runs only (e.g. --backend dense)


def run_ours(argv: list, cwd: str) -> int:
    from geneevolve_tpu import cli

    here = os.getcwd()
    os.chdir(cwd)  # scenario files are referenced relatively
    try:
        return cli.main(argv + OURS_EXTRA)
    finally:
        os.chdir(here)


def run_example(i: int, exdir: str, ref_bin: str, workdir: str, report: dict,
                seeds: int = 1) -> bool:
    """A/B one Example. `seeds` > 1 runs BOTH sides that many times
    (seed, seed+1000, ...) and compares seed-averaged trajectories at
    1/sqrt(seeds)-tightened tolerances — the per-seed tables are also
    checked (at the single-seed tolerances) and recorded."""
    script = os.path.join(exdir, f"Example{i}.sh")
    argv = parse_example_script(script)
    base_seed = int(argv[argv.index("--seed") + 1])
    seed_list = [base_seed + 1000 * k for k in range(seeds)]

    ref_prefixes, our_prefixes = [], []
    for s in seed_list:
        sargv = with_seed(argv, s)
        ref_prefix = os.path.join(workdir, f"ref.ex{i}.s{s}")
        our_prefix = os.path.join(workdir, f"ours.ex{i}.s{s}")
        print(f"== Example {i} (seed {s}): running reference binary ...",
              flush=True)
        subprocess.run(
            [ref_bin] + for_ref_binary(with_prefix(sargv, ref_prefix)),
            cwd=exdir, check=True, capture_output=True, timeout=1800,
        )
        print(f"== Example {i} (seed {s}): running geneevolve_tpu ...",
              flush=True)
        rc = run_ours(with_prefix(sargv, our_prefix), exdir)
        if rc != 0:
            print(f"Example {i}: our CLI failed rc={rc}")
            return False
        ref_prefixes.append(ref_prefix)
        our_prefixes.append(our_prefix)

    npop = 1 + argv.count("--next_population")
    n_pheno = argv.count("--file_cv_info") // npop
    all_ok = True
    for pop in range(1, npop + 1):
        checks = []
        for k, s in enumerate(seed_list):
            ref_cols = read_summary(f"{ref_prefixes[k]}.pop{pop}.summary")
            our_cols = read_summary(f"{our_prefixes[k]}.pop{pop}.summary")
            tag = f"seed {s}: " if seeds > 1 else ""
            checks += [
                (tag + n, r, o, t, ok_)
                for n, r, o, t, ok_ in compare(ref_cols, our_cols, n_pheno)
            ]
        if seeds > 1:
            ref_avg = mean_summaries(
                [f"{p}.pop{pop}.summary" for p in ref_prefixes]
            )
            our_avg = mean_summaries(
                [f"{p}.pop{pop}.summary" for p in our_prefixes]
            )
            checks += [
                (f"avg/{seeds}seeds: " + n, r, o, t, ok_)
                for n, r, o, t, ok_ in compare(
                    ref_avg, our_avg, n_pheno,
                    traj_scale=1.0 / np.sqrt(seeds),
                )
            ]
        report.setdefault("checks", []).extend(
            {"pop": pop, "name": n, "ref": r, "ours": o, "tol": t, "ok": k}
            for n, r, o, t, k in checks
        )
        all_ok &= print_checks(pop, checks)
    return all_ok


def _read_info(path: str) -> dict:
    """{column: list} from a per-individual .info file (either version)."""
    with open(path) as f:
        hdr = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    return {h: [r[i] for r in rows] for i, h in enumerate(hdr)}


def _dual_spouse_rate(info: dict) -> float:
    """Fraction of fathers (of this generation's children) with more than
    one distinct spouse — the observable consequence of `--MM`
    (`Simulation.cpp:2199-2214`: gated individuals are duplicated into the
    mating pool, so they can be rank-matched to two partners)."""
    spouses: dict = {}
    for f_, m_ in zip(info["ID_Father"], info["ID_Mother"]):
        spouses.setdefault(f_, set()).add(m_)
    if not spouses:
        return 0.0
    return sum(1 for s in spouses.values() if len(s) > 1) / len(spouses)


def _household_sizes(info: dict) -> np.ndarray:
    """Children per (father, mother) couple."""
    counts: dict = {}
    for f_, m_ in zip(info["ID_Father"], info["ID_Mother"]):
        counts[(f_, m_)] = counts.get((f_, m_), 0) + 1
    return np.array(sorted(counts.values()))


def run_semantics(tok: str, exdir: str, ref_bin: str, workdir: str,
                  report: dict) -> bool:
    """A/B scenarios for reference semantics no Example exercises:
    `--vf` vertical transmission (`Simulation.cpp:3107-3134`), `--MM`
    double-spouse mating (`:2199-2214`), fixed-offspring law `f`
    (`:2338-2355`), and `--gamma` + `--file_migration` two-population runs
    (`:3345-3381, 877-989`). All run on the Example panel (3 chr x 1,000
    SNPs, 3,000 founders) with seed 12345; the v1.1.0 binary supports every
    flag used here (checked against its --help)."""
    base = [
        "--file_hap_name", "par.pop1.hap_sample_address.txt",
        "--file_recom_map", "Recom.Map.b37.50KbDiff",
        "--file_cv_info", "cv.info",
        "--file_cvs", "par.pop1.cv_hap_files.txt",
        "--seed", "12345",
    ]
    gens = 10
    geninfo = "ex1.popinfo.txt"
    extra: list = []
    npop = 1
    if tok == "vf":
        extra = ["--vf", "0.5"]
    elif tok == "mm":
        extra = ["--MM", "0.3"]
    elif tok == "offf":
        # rewrite the schedule with the fixed-offspring law
        gens = 5
        geninfo = os.path.join(workdir, "offf.popinfo.txt")
        with open(geninfo, "w") as f:
            f.write(
                "pop_size mat_cor offspring_dist selection_func "
                "selection_func_par1 selection_func_par2\n"
            )
            for _ in range(gens):
                f.write("3000 0 f thr 1 1\n")
    elif tok == "gammig":
        npop = 2
        mig = os.path.join(workdir, "gammig.mig.txt")
        with open(mig, "w") as f:
            for _ in range(gens):
                f.write("0.9 0.1 0.1 0.9\n")
        extra = (
            ["--next_population", "--file_gen_info", "ex1.popinfo.txt"]
            + base[:-2]  # second pop: same panel files, no extra seed
            + ["--gamma", "0.5", "--file_migration", mig]
        )
    else:
        raise ValueError(tok)

    argv = ["--file_gen_info", geninfo] + base + extra
    ref_prefix = os.path.join(workdir, f"ref.{tok}")
    our_prefix = os.path.join(workdir, f"ours.{tok}")
    print(f"== semantics[{tok}]: running reference binary ...", flush=True)
    subprocess.run(
        [ref_bin] + for_ref_binary(argv) + ["--prefix", ref_prefix],
        cwd=exdir, check=True, capture_output=True, timeout=1800,
    )
    print(f"== semantics[{tok}]: running geneevolve_tpu ...", flush=True)
    rc = run_ours(argv + ["--prefix", our_prefix], exdir)
    if rc != 0:
        print(f"semantics[{tok}]: our CLI failed rc={rc}")
        return False

    all_ok = True
    for pop in range(1, npop + 1):
        ref_cols = read_summary(f"{ref_prefix}.pop{pop}.summary")
        our_cols = read_summary(f"{our_prefix}.pop{pop}.summary")
        checks = compare(ref_cols, our_cols)

        if tok == "vf":
            # VERSION SKEW: the shipped v1.1.0 binary predates the v1.5.0
            # gen-0 beta adjustment (`Simulation.cpp:648-658`) — its var_F
            # explodes geometrically (observed: gen0 1.04, mean 2.6e3 for
            # vf=0.5), so var_F/var_P/h2 cannot be A/B'd against it. The
            # binary-side checks stop at the genetics (var_A/D/E, above);
            # var_F is checked against the v1.5.0 SOURCE law instead:
            # gen0 F ~ N(0, sqrt(vf)) (`:3095-3096`) and, with beta =
            # sqrt(vf/(2 var_P0)), steady-state var_F ~= vf.
            vf_target = 0.5
            checks = [c for c in checks if "var_P" not in c[0] and "h2" not in c[0]]
            oF = find_col(our_cols, "ph1_var_F", "var_F")
            checks.append((
                "gen0 var_F ~ vf (v1.5.0 law)", vf_target, float(oF[0]),
                0.15,
                bool(abs(oF[0] - vf_target) / vf_target <= 0.15),
            ))
            om = float(np.mean(oF[1:]))
            checks.append((
                "steady var_F ~ vf (v1.5.0 law)", vf_target, om, 0.5,
                bool(abs(om - vf_target) / vf_target <= 0.5),
            ))
        if tok == "mm":
            ri = _read_info(f"{ref_prefix}.info.pop{pop}.gen{gens}.txt")
            oi = _read_info(f"{our_prefix}.info.pop{pop}.gen{gens}.txt")
            rr, oo = _dual_spouse_rate(ri), _dual_spouse_rate(oi)
            checks.append((
                "dual-spouse rate", rr, oo, 0.05, bool(abs(oo - rr) <= 0.05)
            ))
        if tok == "offf":
            ri = _read_info(f"{ref_prefix}.info.pop{pop}.gen{gens}.txt")
            oi = _read_info(f"{our_prefix}.info.pop{pop}.gen{gens}.txt")
            rh, oh = _household_sizes(ri), _household_sizes(oi)
            # the fixed law yields exactly two support points nf/nf+1
            checks.append((
                "household support", len(np.unique(rh)), len(np.unique(oh)),
                0, bool(len(np.unique(oh)) <= 2 and len(np.unique(rh)) <= 2),
            ))
            checks.append((
                "household nf", float(np.min(rh)), float(np.min(oh)), 0,
                bool(np.min(rh) == np.min(oh)),
            ))
            checks.append((
                "mean household", float(np.mean(rh)), float(np.mean(oh)),
                0.05,
                bool(abs(np.mean(oh) - np.mean(rh)) / np.mean(rh) <= 0.05),
            ))
        report.setdefault("checks", []).extend(
            {"pop": pop, "name": n, "ref": r, "ours": o, "tol": t, "ok": k}
            for n, r, o, t, k in checks
        )
        all_ok &= print_checks(pop, checks)
    return all_ok


def _vcf_to_hap_panel(exdir: str, address_file: str, outdir: str) -> dict:
    """Convert a VCF founder panel to hap/legend/indv and write the
    `chr hap legend sample` address file the reference binary's hap path
    expects (`Population.cpp:103-147`). Needed because the shipped v1.1.0
    binary predates VCF support (`--file_ref_vcf` only exists in source
    v1.5.0, `parameters.cpp:44-47`); the founder genetics are identical
    either way, so summary trajectories remain A/B-comparable.

    Returns {chr: nsnp} for downstream schema checks."""
    from geneevolve_tpu.io import hap as hapio
    from geneevolve_tpu.io import vcf as vcfio

    os.makedirs(outdir, exist_ok=True)
    nsnp = {}
    rows = []
    with open(os.path.join(exdir, address_file)) as f:
        next(f)  # "chr file" header
        for line in f:
            parts = line.split()
            if not parts:
                continue
            chrom, vcf_path = parts[0], parts[1]
            v = vcfio.read_vcf(os.path.join(exdir, vcf_path))
            base = os.path.join(outdir, f"conv.chr{chrom}")
            hapio.write_hap(base + ".hap", v.hap)
            with open(base + ".legend", "w") as lf:
                lf.write("id position a0 a1\n")
                for j in range(v.nsnp):
                    rid = v.ids[j] if v.ids[j] != "." else f"snp{chrom}_{j}"
                    lf.write(f"{rid} {v.pos[j]} {v.ref[j]} {v.alt[j]}\n")
            hapio.write_indv(base + ".indv", v.samples)
            rows.append((chrom, base))
            nsnp[chrom] = v.nsnp
    addr = os.path.join(outdir, "conv.hap_address.txt")
    with open(addr, "w") as f:
        f.write("chr hap legend sample\n")
        for chrom, base in rows:
            f.write(f"{chrom} {base}.hap {base}.legend {base}.indv\n")
    return nsnp


def run_vcf_example(ref_bin: str, workdir: str, report: dict,
                    zip_path: str = DEFAULT_VCF_ZIP) -> bool:
    """The Example2.zip 22-chromosome VCF scenario (main.sh), with a fixed
    seed added (the script relies on the time-based default).

    The v1.1.0 binary has no VCF input/output and no
    `--file_output_generations` (those are v1.5.0 source features), so the
    A/B design is: binary runs on a hap-converted copy of the same founder
    panel; ours runs the true VCF path end-to-end. Deterministic gen-0
    variance components and trajectory means must still agree (identical
    founders + CV effects). Our VCF outputs are checked against the v1.5.0
    source contract (`Simulation.cpp:1690-1758`) directly."""
    exroot = os.path.join(workdir, "vcf_example")
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(exroot)
    exdir = os.path.join(exroot, "Example2")

    ref_prefix = os.path.join(workdir, "ref.vcf")
    our_prefix = os.path.join(workdir, "ours.vcf")

    print("== VCF example: converting VCF founders to hap for the v1.1.0 "
          "binary ...", flush=True)
    convdir = os.path.join(workdir, "vcf_as_hap")
    nsnp = _vcf_to_hap_panel(exdir, "par.vcf_sample_address.txt", convdir)

    # Example2's CV hap files carry 300 rows/chr but par.cv.info lists 50;
    # v1.5.0 silently uses only the first 50 (`Simulation.cpp:2762-2767`)
    # while v1.1.0 hard-errors on the count mismatch — hand the binary
    # trimmed copies holding exactly the rows the v1.5.0 semantics use.
    ncv_per_chr = {}
    with open(os.path.join(exdir, "par.cv.info")) as f:
        next(f)
        for line in f:
            parts = line.split()
            if parts:
                ncv_per_chr[parts[0]] = ncv_per_chr.get(parts[0], 0) + 1
    trimmed_cvs = os.path.join(convdir, "conv.cv_hap_files.txt")
    with open(os.path.join(exdir, "par.cv_hap_files.txt")) as f, \
            open(trimmed_cvs, "w") as out:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            chrom, path = parts[0], parts[1]
            trimmed = os.path.join(convdir, f"conv.cv.chr{chrom}.hap")
            with open(os.path.join(exdir, path)) as src, \
                    open(trimmed, "w") as dst:
                for k, row in enumerate(src):
                    if k >= ncv_per_chr[chrom]:
                        break
                    dst.write(row)
            out.write(f"{chrom} {trimmed}\n")

    common = [
        "--file_recom_map", "Recom.Map.b37.50KbDiff",
        "--file_cv_info", "par.cv.info",
        "--va", ".4", "--ve", ".6",
        "--seed", "12345",
    ]
    print("== VCF example: running reference binary (hap-converted panel) "
          "...", flush=True)
    subprocess.run(
        [ref_bin, "--file_gen_info", "par.geninfo.txt",
         "--file_hap_name",
         os.path.join(convdir, "conv.hap_address.txt"),
         "--file_cvs", trimmed_cvs]
        + common + ["--prefix", ref_prefix],
        cwd=exdir, check=True, capture_output=True, timeout=1800,
    )
    print("== VCF example: running geneevolve_tpu (native VCF path) ...",
          flush=True)
    rc = run_ours(
        ["--file_gen_info", "par.geninfo.txt",
         "--file_ref_vcf", "par.vcf_sample_address.txt",
         "--file_cvs", "par.cv_hap_files.txt",
         "--file_output_generations", "par.output.txt",
         "--out_vcf"] + common + ["--prefix", our_prefix],
        exdir)
    if rc != 0:
        print(f"VCF example: our CLI failed rc={rc}")
        return False

    ref_cols = read_summary(f"{ref_prefix}.pop1.summary")
    our_cols = read_summary(f"{our_prefix}.pop1.summary")
    checks = compare(ref_cols, our_cols)

    # Schema checks on our VCF output vs the v1.5.0 source contract:
    # one file per pop/gen/chr, record count == panel biallelic count,
    # samples == the generation's REALIZED size (~Poisson(pop_size), the
    # reference offspring law `Simulation.cpp:2329-2337`) named g<gen>_<id>
    # (`:1729`), required meta lines (`:1716-1724`).
    pop_size = 1000  # par.geninfo.txt nominal rows
    for gen in (4, 5):
        with open(f"{our_prefix}.info.pop1.gen{gen}.txt") as f:
            realized = sum(1 for _ in f) - 1
        assert abs(realized - pop_size) < 6 * pop_size ** 0.5, realized
        for chrom in ("1", "22"):
            op = f"{our_prefix}.pop1.gen{gen}.chr{chrom}.vcf"
            on = _vcf_schema(op)
            checks.append(
                (f"vcf gen{gen} chr{chrom} records", nsnp[chrom],
                 on["records"], 0, bool(on["records"] == nsnp[chrom])))
            checks.append(
                (f"vcf gen{gen} chr{chrom} samples", realized,
                 on["samples"], 0, bool(on["samples"] == realized)))
            checks.append(
                (f"vcf gen{gen} chr{chrom} sample0", 0, 0, 0,
                 bool(on["sample0"] == f"g{gen}_1")))
            checks.append(
                (f"vcf gen{gen} chr{chrom} meta", 0, 0, 0,
                 bool(on["meta_ok"])))
    report.setdefault("checks", []).extend(
        {"pop": 1, "name": n, "ref": r, "ours": o, "tol": t, "ok": k}
        for n, r, o, t, k in checks
    )
    return print_checks(1, checks)


def _vcf_schema(path: str) -> dict:
    records = 0
    samples = 0
    sample0 = ""
    meta = []
    with open(path) as f:
        for line in f:
            if line.startswith("##"):
                meta.append(line.rstrip("\n"))
                continue
            if line.startswith("#CHROM"):
                parts = line.rstrip("\n").split("\t")
                samples = len(parts) - 9
                sample0 = parts[9] if samples else ""
                continue
            records += 1
    meta_ok = any(m.startswith("##fileformat=VCFv4.1") for m in meta) and any(
        m.startswith("##CreatedBy=") for m in meta)
    return {"records": records, "samples": samples, "sample0": sample0,
            "meta_ok": meta_ok}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples", default="")
    ap.add_argument("--ref-bin", default=DEFAULT_REF_BIN)
    ap.add_argument("--only", default="1,2,3,4,5,6,7,8,9,10,vcf")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="", help="write a JSON report here")
    ap.add_argument(
        "--ours-extra", default="",
        help="space-separated extra flags for OUR runs only "
        "(e.g. '--backend dense')",
    )
    ap.add_argument(
        "--seeds", type=int, default=1,
        help="run each Example this many times (varying --seed) and also "
        "compare seed-averaged trajectories at tightened tolerances",
    )
    args = ap.parse_args()
    if args.ours_extra:
        OURS_EXTRA.extend(args.ours_extra.split())

    exdir = args.examples
    tmp = None
    if not exdir:
        tmp = tempfile.mkdtemp(prefix="ge_parity_")
        with zipfile.ZipFile(DEFAULT_ZIP) as z:
            z.extractall(tmp)
        exdir = os.path.join(tmp, "Examples")
    workdir = args.workdir or tempfile.mkdtemp(prefix="ge_parity_out_")
    os.makedirs(workdir, exist_ok=True)

    results = {}
    reports = {}
    ok = True
    for tok in [s.strip() for s in args.only.split(",") if s.strip()]:
        report: dict = {}
        try:
            if tok == "vcf":
                good = run_vcf_example(args.ref_bin, workdir, report)
            elif tok in ("vf", "mm", "offf", "gammig"):
                good = run_semantics(tok, exdir, args.ref_bin, workdir, report)
            else:
                good = run_example(int(tok), exdir, args.ref_bin, workdir,
                                   report, seeds=args.seeds)
        except subprocess.CalledProcessError as e:
            err = e.stderr.decode() if isinstance(e.stderr, bytes) else str(e.stderr)
            print(f"Example {tok}: reference binary failed: {err[:500]}")
            report["error"] = f"reference binary: {err[:500]}"
            good = False
        except Exception:
            print(f"Example {tok}: harness error:")
            traceback.print_exc()
            report["error"] = traceback.format_exc(limit=5)
            good = False
        report["ok"] = bool(good)
        results[tok] = bool(good)
        reports[tok] = report
        ok &= good

    payload = {
        "parity": results,
        "all_ok": bool(ok),
        "n_pass": sum(results.values()),
        "n_total": len(results),
        "details": reports,
    }
    print(json.dumps({"parity": results, "all_ok": bool(ok)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
