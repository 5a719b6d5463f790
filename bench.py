"""Benchmark: dense-engine generation throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": "ind_loci_gens_per_s", "value": N, "unit": "ind*loci*gens/s",
   "vs_baseline": N, "device": {...}, ...}

All narration (stage heartbeats, full tracebacks) goes to stderr so a killed
or failed run still shows where it died and why. The run fails unless JAX
finds a GPU.

Ordering and budget: the MAIN measurement runs FIRST; the bandwidth
ceilings and the couples on/off A/B run afterwards, each gated on the
remaining time budget (BENCH_BUDGET_S, default 420 s). On an out-of-memory
error the main measurement retries once at half the population; the
retry is printed and recorded in the JSON (`n_halved`).

Extra keys (all measured on the same card, same run):
  bytes_per_s       effective HBM traffic of the generation step, using the
                    packed engine's floor of 0.75 B per ind*locus*gen
                    (6 passes over n*m/8-byte planes: 4 parent gathers +
                    2 child writes, `dense/packed.py`)
  pct_of_ceiling    measured_rate / speed-of-light rate, where speed of
                    light is 3x the packed state (read father planes +
                    read mother planes + write child planes) priced at the
                    measured row-gather bandwidth on this card
  gather_GBps       measured row-gather copy bandwidth on this card
  stream_GBps       measured streaming (read+write) bandwidth on this card
  value_couples_off A/B: same shape with the couple-sorted sibling layout
                    disabled (per-child parent gather); null if skipped

vs_baseline compares against the reference GeneEvolve's effective rate at its
largest published config: 300,000 individuals x 320,926 loci / 1,121.8 s per
generation = 8.58e7 ind*loci*gens/s (BASELINE.md, PDF Table 3.1) — the
honest apples-to-apples number since the dense engine materializes every
genotype every generation while the reference only tracks intervals
(/root/reference/src/Simulation.cpp:1890-2082 loop).
"""

import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from geneevolve_tpu.cli import _enable_compilation_cache

REF_RATE = 300_000 * 320_926 / 1_121.8  # reference ind*loci*gens/s

_T0 = time.time()


def hb(msg: str) -> None:
    """Stage heartbeat on stderr (stdout is reserved for the JSON line)."""
    print(f"[bench {time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _free_all_device_buffers() -> None:
    """Drop every live device array (before the out-of-memory retry)."""
    for a in jax.live_arrays():
        a.delete()


def _time(fn, *args, reps: int = 3) -> float:
    """Median wall time of fn(*args) after one warmup."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def measure_ceilings(n: int = 8192, mw: int = 16384, loops: int = 16):
    """(gather_GBps, stream_GBps) on this card, at a fixed ~1 GiB shape.

    Each measurement chains `loops` dependent passes inside ONE dispatch so
    the per-dispatch launch latency is amortized out of the estimate."""
    key = jax.random.key(0)
    hap = jax.random.bits(key, (n, 2, mw), dtype=jnp.uint32)
    idx = jax.random.randint(jax.random.key(1), (n,), 0, n)

    @jax.jit
    def gather(h, i):
        def body(_, x):
            return x[i]

        return jax.lax.fori_loop(0, loops, body, h)

    @jax.jit
    def stream(h):
        def body(k, x):
            # iteration-dependent constant: XOR passes cannot fold away
            return x ^ k.astype(jnp.uint32)

        return jax.lax.fori_loop(0, loops, body, h)

    bytes_state = n * 2 * mw * 4
    dt_g = _time(gather, hap, idx) / loops
    dt_s = _time(stream, hap) / loops
    del hap, idx
    gather_gbps = 2 * bytes_state / dt_g / 1e9  # read (gathered) + write
    stream_gbps = 2 * bytes_state / dt_s / 1e9  # read + write
    return gather_gbps, stream_gbps


def run(
    n: int,
    m: int,
    gens: int,
    reps: int = 3,
    couples: bool | None = None,
) -> float:
    from geneevolve_tpu.dense.packed import (
        PackedConfig,
        init_state_streamed,
        make_step,
    )

    if couples is None:
        couples = os.environ.get("BENCH_COUPLES", "1") == "1"
    cfg = PackedConfig(
        n=n,
        m=m,
        n_chr=8,
        morgans_per_chr=1.0,
        xo_cap=8,
        mut_rate=1.0,
        mut_cap=8,
        ncv=256,
        selection=True,
        # reference household law: couples + multinomial children sorted
        # by couple
        couples=couples,
    )
    state = init_state_streamed(jax.random.key(0), cfg)
    step = make_step(cfg)

    # all generations inside one jit (lax.scan): measures device time, not
    # per-dispatch overhead. The state is donated so the carry is double-
    # not triple-buffered.
    from functools import partial as _partial

    @_partial(jax.jit, donate_argnums=0)
    def evolve(state, key):
        def body(st, k):
            return step(st, k), ()

        out, _ = jax.lax.scan(body, state, jax.random.split(key, gens))
        return out

    state = jax.block_until_ready(evolve(state, jax.random.key(1)))
    hb(f"run(n={n}, m={m}, gens={gens}, couples={couples}): compiled + warm")
    ts = []
    for rep in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(evolve(state, jax.random.key(2 + rep)))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    clip = int(state.get("clip", 0))
    del state
    return n * m * gens / ts[len(ts) // 2], clip


def _is_oom(e: Exception) -> bool:
    msg = str(e)
    return (
        "RESOURCE_EXHAUSTED" in msg
        or "Out of memory" in msg
        or "Ran out of memory" in msg
    )


def main() -> None:
    _enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    # 16k individuals x 1 Mi loci = 4 GiB packed state (double-buffered
    # under scan); the first benchmark PR re-sizes the cells
    n = int(os.environ.get("BENCH_N", 16384))
    m = int(os.environ.get("BENCH_M", 1_048_576))
    gens = int(os.environ.get("BENCH_GENS", 5))
    reps = int(os.environ.get("BENCH_REPS", 3))
    budget = float(os.environ.get("BENCH_BUDGET_S", 420))
    couples_default = os.environ.get("BENCH_COUPLES", "1") == "1"
    hb(f"start: {dev.device_kind} n={n} m={m} gens={gens} reps={reps} "
       f"budget={budget:.0f}s")

    def left() -> float:
        return budget - (time.time() - _T0)

    # MAIN measurement FIRST; one halved-n retry on OOM, recorded
    n_halved = False
    try:
        rate, clip = run(n, m, gens, reps=reps)
    except Exception as e:
        if not _is_oom(e):
            raise
        traceback.print_exc(file=sys.stderr)
        _free_all_device_buffers()
        n //= 2
        n_halved = True
        hb(f"OOM -> retrying once at half the population, n={n}")
        rate, clip = run(n, m, gens, reps=reps)
    hb(f"main rate = {rate:.4e} ind*loci*gens/s (clip={clip})")

    gather_gbps = stream_gbps = None
    if left() > 45:
        hb("bandwidth ceilings")
        gather_gbps, stream_gbps = measure_ceilings()
        hb(f"gather={gather_gbps:.1f} GB/s stream={stream_gbps:.1f} GB/s")
    else:
        hb("budget exhausted -> skipping ceilings")

    # couples on/off A/B at the main shape (cheap: compile is the cost)
    rate_ab = None
    if os.environ.get("BENCH_AB", "1") == "1" and left() > 90:
        hb(f"A/B: couples={not couples_default}")
        rate_ab, _ = run(
            n, m, gens, reps=max(1, reps - 1), couples=not couples_default,
        )
        hb(f"A/B rate (couples={not couples_default}) = {rate_ab:.4e}")
    else:
        hb("skipping couples A/B (disabled or budget exhausted)")

    gen_dt = n * m * gens / rate / gens  # seconds per generation
    bytes_per_gen = n * (m // 8) * 6  # 0.75 B per ind*locus
    # speed of light: one generation's irreducible motion is 3x the packed
    # state — read the father's two planes and the mother's two planes
    # (gathered rows) and write the child's two planes. Priced at the
    # measured gather bandwidth (gather_GBps already counts read+write).
    state_bytes = n * 2 * (m // 32) * 4
    sol = pct = None
    if gather_gbps:
        sol = 3 * state_bytes / (gather_gbps * 1e9)
        pct = sol / gen_dt

    print(
        json.dumps(
            {
                "metric": "ind_loci_gens_per_s",
                "value": rate,
                "unit": "ind*loci*gens/s",
                "vs_baseline": rate / REF_RATE,
                "bytes_per_s": rate * 0.75,
                "pct_of_ceiling": pct,
                "gather_GBps": gather_gbps,
                "stream_GBps": stream_gbps,
                "sol_s_per_gen": sol,
                "s_per_gen": gen_dt,
                "bytes_per_gen": bytes_per_gen,
                "n": n,
                "n_halved": n_halved,
                "m": m,
                "gens": gens,
                "couples": couples_default,
                "value_couples_on": rate if couples_default else rate_ab,
                "value_couples_off": rate_ab if couples_default else rate,
                # truncated Poisson draws across reps*gens warm steps (tiny
                # at defaults; large means xo_cap/mut_cap are undersized)
                "xo_clip_count": clip,
                # draws/gen = 2 gametes x (n_chr=8 xo draws + 1 mut draw) x n
                "xo_clip_rate": clip / ((reps + 1.0) * gens * n * 18),
                "wall_s": round(time.time() - _T0, 1),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    hb("done")


if __name__ == "__main__":
    main()
