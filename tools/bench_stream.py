"""Beyond-HBM streamed packed engine benchmark (SURVEY §7.2 step 7).

    python tools/bench_stream.py --n 8192 --m_gib 96 --gens 3 \
        --json chiprun_out/bench_stream.json

Builds a packed genome of `--m_gib` GiB (pick it above the card's memory),
evolves it with `dense/streamed.py` (chromosome slabs round-tripping
host<->device, uploads prefetched), and reports throughput plus the
transfer/compute split. The point is capability + an honest rate: the
host link bounds throughput, and the artifact records exactly how.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--m_gib", type=float, default=24.0,
                    help="target packed state size in GiB")
    ap.add_argument("--gens", type=int, default=3)
    ap.add_argument("--n_chr", type=int, default=16)
    ap.add_argument("--slab_chrs", type=int, default=2)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    from geneevolve_tpu.dense.packed import PackedConfig
    from geneevolve_tpu.dense.streamed import StreamedPacked

    # m from the state target: n * 2 chromatids * m/8 bytes
    m = int(args.m_gib * 2**30 * 8 / (args.n * 2))
    unit = 32 * 128 * args.n_chr
    m = (m // unit) * unit
    cfg = PackedConfig(
        n=args.n, m=m, n_chr=args.n_chr, morgans_per_chr=1.0,
        xo_cap=8, mut_rate=0.0, mut_cap=2, ncv=0, selection=False,
    )
    print(f"building founders: n={cfg.n} m={cfg.m} "
          f"state={cfg.n * 2 * cfg.m / 8 / 2**30:.2f} GiB", flush=True)
    t0 = time.time()
    eng = StreamedPacked.build(jax.random.key(0), cfg, args.slab_chrs,
                               verbose=True)
    t_build = time.time() - t0

    f0 = eng.allele_mean(0)
    per_gen = []
    for g in range(args.gens):
        t0 = time.time()
        eng.step(jax.random.fold_in(jax.random.key(1), g))
        per_gen.append(time.time() - t0)
        print(f"  gen {g + 1}: {per_gen[-1]:.1f} s "
              f"(h2d {eng.h2d_s:.1f} d2h {eng.d2h_s:.1f} cumulative)",
              flush=True)
    f1 = eng.allele_mean(0)

    s_gen = sorted(per_gen)[len(per_gen) // 2]
    rate = cfg.n * cfg.m / s_gen
    res = {
        "metric": "streamed_packed_ind_loci_per_s",
        "value": rate,
        "unit": "ind*loci*gens/s",
        "state_gib": round(eng.state_bytes / 2**30, 2),
        "hbm_gib": 15.75,
        "n": cfg.n,
        "m": cfg.m,
        "n_chr": cfg.n_chr,
        "slabs": len(eng.host),
        "gens": args.gens,
        "s_per_gen": round(s_gen, 2),
        "per_gen_s": [round(t, 2) for t in per_gen],
        "h2d_s_total": round(eng.h2d_s, 2),
        "d2h_s_total": round(eng.d2h_s, 2),
        "build_s": round(t_build, 2),
        "allele_mean_gen0": round(f0, 4),
        "allele_mean_end": round(f1, 4),
        "backend": jax.default_backend(),
    }
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
