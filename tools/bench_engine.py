"""Benchmark the full-semantics segment engine (the CLI path) at reference
scale.

The reference's headline table (`GeneEvolveDocumentation.pdf` Table 3.1,
BASELINE.md) times the main simulation loop only — I/O excluded — at
population sizes 3k/30k/300k on a 320,926-SNP panel, where its per-generation
cost is loci-independent (interval representation). This harness reproduces
those shapes with tools/mkscenario.py (22 chromosomes, ~37 Morgan map, 2,200
CVs; the panel SNP count is irrelevant to BOTH main loops by construction)
and runs the real `Simulation` class end to end, reporting steady-state
seconds/generation and the StageTimer breakdown.

    python tools/bench_engine.py --pop_size 300000 --gens 10 \
        --json chiprun_out/bench_engine.json

Writes one JSON object; `vs_baseline` is reference_s_per_gen / ours at the
matching Table 3.1 row (or scaled linearly in n between rows, since the
reference's cost is O(n) per generation).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Table 3.1, spousal corr 0.0 rows: n -> s/gen (BASELINE.md)
REF_S_PER_GEN = {3_000: 5.8, 30_000: 57.7, 300_000: 1_121.8}


def ref_s_per_gen(n: int) -> float:
    """Reference seconds/generation at population size n: exact at a
    published row, linear in n otherwise (the reference is O(n·p·g),
    PDF §3.6)."""
    if n in REF_S_PER_GEN:
        return REF_S_PER_GEN[n]
    return 1_121.8 * n / 300_000


# stages whose time is host-side Python/numpy (everything else is device
# compute + the one designed host sync per generation)
HOST_STAGES = ("mate", "phenotypes", "gamma_mv_sv", "info_files")


def run_bench(
    pop_size: int,
    gens: int,
    n0: int,
    nchr: int,
    ncv: int,
    mat_cor: float,
    scenario_dir: str,
    seed: int = 12345,
    keep_outputs: bool = False,
    stage_sync: bool = False,
) -> dict:
    from tools.mkscenario import make_scenario

    t0 = time.time()
    flags = make_scenario(
        scenario_dir, n0=n0, pop_size=pop_size, gens=gens, nchr=nchr,
        ncv=ncv, mat_cor=mat_cor,
    )
    t_gen_files = time.time() - t0

    from geneevolve_tpu.cli import _enable_compilation_cache
    from geneevolve_tpu.config import parse_args
    from geneevolve_tpu.core.engine import Simulation

    _enable_compilation_cache()

    prefix = os.path.join(scenario_dir, "bench_out")
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    argv += ["--seed", str(seed), "--prefix", prefix]
    if stage_sync:
        # device fence after each stage: the breakdown becomes device-true
        # (headline s/gen runs leave this off to keep async overlap)
        argv += ["--stage_sync"]
    cfg = parse_args(argv)

    t0 = time.time()
    sim = Simulation(cfg, verbose=False)
    t_load = time.time() - t0
    t0 = time.time()
    sim.init_generation0()
    t_gen0 = time.time() - t0

    # generations 1-2 compile (two population shapes: n0->n, n->n); the
    # steady-state stage breakdown starts after them
    warmup = min(2, sim.tot_gen - 1)
    per_gen = []
    warm_totals = {}
    for gen in range(1, sim.tot_gen + 1):
        t0 = time.time()
        sim.step(gen)
        per_gen.append(time.time() - t0)
        if gen == warmup:
            warm_totals = dict(sim.timer.totals)
    sim.write_summary()

    steady = sorted(per_gen[warmup:] or per_gen)
    s_per_gen = steady[len(steady) // 2]
    n_steady = max(len(per_gen) - warmup, 1)
    stage_s = {
        k: (v - warm_totals.get(k, 0.0)) / n_steady
        for k, v in sim.timer.totals.items()
    }
    host_s = sum(stage_s.get(k, 0.0) for k in HOST_STAGES)
    ref = ref_s_per_gen(pop_size)
    from geneevolve_tpu.utils import telemetry

    import jax

    vm, rss = telemetry.process_mem_usage()
    hbm = telemetry.device_memory_mb()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "metric": "segment_engine_s_per_gen",
        "value": s_per_gen,
        "unit": "s/gen",
        "vs_baseline": ref / s_per_gen,
        "ref_s_per_gen": ref,
        "pop_size": pop_size,
        "n0": n0,
        "gens": gens,
        "nchr": nchr,
        "ncv_total": ncv * nchr,
        "mat_cor": mat_cor,
        "seg_capacity": sim.s_cap,
        "per_gen_s": [round(t, 3) for t in per_gen],
        "stage_s_per_gen": {k: round(v, 4) for k, v in stage_s.items()},
        "host_s_per_gen": round(host_s, 4),
        "host_frac": round(host_s / s_per_gen, 4),
        "max_host_stage_frac": round(
            max(
                (stage_s.get(k, 0.0) for k in HOST_STAGES), default=0.0
            )
            / s_per_gen,
            4,
        ),
        "load_s": round(t_load, 2),
        "gen0_s": round(t_gen0, 2),
        "mkscenario_s": round(t_gen_files, 2),
        "rss_mb": round(rss),
        "hbm_mb": {k: round(v) for k, v in hbm.items()},
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "stage_sync": stage_sync,
        "backend": jax.default_backend(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pop_size", type=int, default=300_000)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--n0", type=int, default=10_000)
    ap.add_argument("--nchr", type=int, default=22)
    ap.add_argument("--ncv", type=int, default=100)
    ap.add_argument("--mat_cor", type=float, default=0.0)
    ap.add_argument("--scenario_dir", default="")
    ap.add_argument("--json", default="")
    ap.add_argument("--stage_sync", action="store_true")
    args = ap.parse_args(argv)

    sdir = args.scenario_dir or tempfile.mkdtemp(prefix="ge_bench_")
    res = run_bench(
        args.pop_size, args.gens, args.n0, args.nchr, args.ncv,
        args.mat_cor, sdir, stage_sync=args.stage_sync,
    )
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
