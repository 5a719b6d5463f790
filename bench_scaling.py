"""Weak-scaling harness for the sharded packed engine.

Runs the (ind x loci)-mesh generation step on 1/2/4/8 virtual devices with
the problem grown proportionally (weak scaling) and reports per-device
throughput efficiency. Runs on the CPU backend
(`--xla_force_host_platform_device_count`) so it validates the *scaling
structure* (shardings, collectives, no accidental all-gathers) anywhere;
every subprocess is pinned to the CPU, so none opens a GPU.

Prints one JSON line per mesh size plus a final summary line:
  {"metric": "weak_scaling_efficiency", "value": eff, ...}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BASE_N = int(os.environ.get("SCALE_N", 512))
BASE_M = int(os.environ.get("SCALE_M", 32768))
GENS = int(os.environ.get("SCALE_GENS", 4))


def run_one(n_dev: int) -> None:
    import jax

    from geneevolve_tpu.dense.packed import PackedConfig, init_state
    from geneevolve_tpu.parallel import (
        make_deme_step,
        make_mesh,
        make_sharded_step,
        shard_state,
    )
    from geneevolve_tpu.parallel.mesh import make_routed_step

    mode = os.environ.get("SCALE_MODE", "deme")  # deme | panmictic | routed
    devices = jax.devices("cpu")[:n_dev]
    assert len(devices) == n_dev, (len(devices), n_dev)
    mesh = make_mesh(devices)
    ind, loci = mesh.devices.shape
    cfg = PackedConfig(
        n=BASE_N * ind,
        m=BASE_M * loci,
        n_chr=4 * loci,
        morgans_per_chr=1.0,
        xo_cap=8,
        mut_rate=0.5,
        mut_cap=4,
        ncv=64,
        selection=True,
    )
    state = shard_state(init_state(jax.random.key(0), cfg), mesh)
    step = {
        "deme": lambda: make_deme_step(cfg, mesh),
        "panmictic": lambda: make_sharded_step(cfg, mesh),
        # routed: exact panmictic law, request-routed parent fetches
        # instead of the parent-plane all-gather
        "routed": lambda: make_routed_step(cfg, mesh),
    }[mode]()

    out = state
    for g in range(2):  # warmup/compile
        out = step(out, jax.random.fold_in(jax.random.key(1), g))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for g in range(GENS):
        out = step(out, jax.random.fold_in(jax.random.key(2), g))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    rate = cfg.n * cfg.m * GENS / dt
    print(
        json.dumps(
            {
                "devices": n_dev,
                "mesh": list(mesh.devices.shape),
                "n": cfg.n,
                "m": cfg.m,
                "rate": rate,
                "rate_per_device": rate / n_dev,
            }
        ),
        flush=True,
    )


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--run":
        run_one(int(sys.argv[2]))
        return 0
    sizes = [1, 2, 4, 8]
    per_dev = {}
    for d in sizes:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={d}"
        ).strip()
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", str(d)],
            env=env,
            capture_output=True,
            text=True,
            timeout=2400,
        )
        sys.stderr.write(out.stderr[-2000:] if out.returncode else "")
        line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
        print(line, flush=True)
        per_dev[d] = json.loads(line)
    # On virtual CPU devices every "device" shares one physical CPU, so the
    # per-device rate CANNOT stay flat (the classic weak-scaling metric
    # presumes independent hardware per device). What this harness CAN
    # measure honestly is structural overhead: with the problem grown
    # N-fold over N virtual devices, the TOTAL rate on a fixed CPU stays
    # constant iff the sharded program does no redundant work and no
    # superlinear collective traffic. total_rate(N)/total_rate(1) is
    # therefore the structure-efficiency reported here; per-device rates
    # are echoed for a real multi-chip slice to interpret.
    eff = per_dev[sizes[-1]]["rate"] / per_dev[sizes[0]]["rate"]
    print(
        json.dumps(
            {
                "metric": "weak_scaling_structure_efficiency",
                "value": eff,
                "unit": (
                    f"total rate @{sizes[-1]} virtual dev / @1 "
                    "(1.0 = no redundant work; shared-CPU harness)"
                ),
                "vs_baseline": eff / 0.8,
                "per_device_rates": {
                    d: per_dev[d]["rate_per_device"] for d in sizes
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    raise SystemExit(main())
