"""Roofline share of the two hot XLA stages on the GPU, at the smoke
run's shapes.

    python tools/stage_roofline.py [--json chiprun_out/roofline.json]

- capacity probe (segment engine): `segments.count_merge_valid` of both
  parents' gathered ledger rows for 22 chromosomes, at 300,000 children
  and the ledger capacity of a 3-generation 22-chromosome run; and the
  whole `_capacity_probe` program (samplers + counts, 22 chromosomes);
- dense meiosis (dense engine): the jitted `_reproduce_planes` of
  `dense/backend.py` at 100,000 children x 320,936 loci, without and with
  de novo mutations, in its XLA form and as its Triton kernel
  (`ops/meiosis_triton.py`), after a check that both give bit-equal
  outputs on the card.

Each stage is timed as the median wall time of jitted calls ended by
`block_until_ready` (one program per call, so launch overhead is
microseconds), and priced against the bytes it must move: the probe
reads n x 2 parents x 2S slots x 4 B of ledger rows plus n x 2 x K x 4 B
of crossovers; the dense step makes 6 passes over n x m/8 bytes (4 parent
planes read, 2 child planes written). The share is given against the
H100's published 3.35 TB/s and against a plain device copy measured in
the same process. Prints one JSON object; refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def timed(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def copy_rate(nbytes: int) -> float:
    """Bytes/s (read + write) of a plain device copy of `nbytes`."""
    x = jnp.zeros((nbytes // 4,), jnp.uint32)
    f = jax.jit(lambda a: a ^ jnp.uint32(1))
    return 2 * nbytes / timed(f, x)


def row(name: str, seconds: float, nbytes: int, copy_bps: float) -> dict:
    bps = nbytes / seconds
    return {
        "stage": name, "seconds": seconds, "bytes": nbytes,
        "GBps": bps / 1e9, "pct_of_3.35TBps": 100 * bps / PEAK_BYTES_S,
        "pct_of_copy": 100 * bps / copy_bps,
    }


def ab_rows(name, nbytes, copy_bps, xla, kernel, *args, reps=5) -> list:
    """Time the XLA and the kernel form of a stage on the same inputs, after
    checking that their outputs are bit-equal."""
    want = jax.tree.leaves(jax.block_until_ready(xla(*args)))
    got = jax.tree.leaves(jax.block_until_ready(kernel(*args)))
    if not all(bool(jnp.array_equal(w, g)) for w, g in zip(want, got)):
        raise AssertionError(f"{name}: kernel output differs from XLA")
    del want, got
    return [
        row(f"{name} (XLA)", timed(xla, *args, reps=reps), nbytes, copy_bps),
        row(f"{name} (Triton kernel)", timed(kernel, *args, reps=reps),
            nbytes, copy_bps),
    ]


def probe_stages(n: int, nchr: int, copy_bps: float) -> list:
    """The count alone, then the whole probe program (XLA)."""
    from geneevolve_tpu.core import segments
    from geneevolve_tpu.core.engine import _capacity_probe

    # capacities of the 3-generation, 22-chromosome, 37-Morgan run
    L, G = 3.24, 3
    S = int(8 + np.ceil(G * L + 6 * np.sqrt(G * L)))
    K = int(8 + np.ceil(L + 6 * np.sqrt(L)))
    rng = np.random.default_rng(0)
    big = segments._big()
    live = 8
    st = np.full((n, 2, S), big, np.int32)
    st[..., :live] = np.sort(rng.integers(1, 249_000_000, (n, 2, live)), -1)
    st[..., 0] = 0
    xo = np.full((n, K), big, np.int32)
    xo[:, :3] = np.sort(rng.integers(1, 249_000_000, (n, 3)), -1)
    xo_d = jnp.asarray(xo)
    sh = jnp.asarray(rng.integers(0, 2, n, dtype=np.int32))
    fa = jnp.asarray(rng.integers(0, n, n, dtype=np.int32))
    mo = jnp.asarray(rng.integers(0, n, n, dtype=np.int32))
    stack = jnp.asarray(np.broadcast_to(st, (nchr,) + st.shape))

    # both parents' counts for every chromosome in one program
    count = jax.jit(lambda stack, xo, sh, fa, mo: [
        (segments.count_merge_valid(stack[c][fa], xo, sh),
         segments.count_merge_valid(stack[c][mo], xo, sh))
        for c in range(stack.shape[0])
    ])
    nbytes = nchr * (n * 2 * 2 * S * 4 + n * 2 * K * 4)
    out = [row(f"probe count, {nchr} chromosomes",
               timed(count, stack, xo_d, sh, fa, mo), nbytes, copy_bps)]

    # the whole probe program: samplers + counts over nchr chromosomes
    from tools.mkscenario import CHR_MB

    bw = 50_000
    kmax = max(CHR_MB[:nchr]) * 1_000_000 // bw + 1
    bp = np.stack([np.minimum(np.arange(kmax) * bw, CHR_MB[c] * 1_000_000)
                   for c in range(nchr)]).astype(np.int32)
    mass = np.diff(bp, axis=1, prepend=0) * 1.3e-8  # 1.3 cM/Mb
    cum = np.cumsum(mass, axis=1).astype(np.float32)
    grids = [segments.build_cdf_grid(c) for c in cum]
    T = max(g[0].shape[0] for g in grids)
    tabs = [segments.build_cdf_grid(c, force_t=T) for c in cum]
    W = max(w for _, w in tabs)
    tabs = [segments.build_cdf_grid(c, force_t=T, force_w=W)[0] for c in cum]
    args = (
        stack, jnp.full((nchr, n, 2, 2), big, jnp.int32), fa, mo,
        jax.random.key(1), jnp.asarray(bp), jnp.asarray(cum),
        jnp.asarray(cum[:, -1]), jnp.full((nchr,), bw, jnp.float32),
        jnp.zeros((nchr, 2), jnp.int32), jnp.zeros((nchr, 2), jnp.float32),
        jnp.zeros((nchr,), jnp.float32),
    )
    grid = jnp.asarray(np.stack(tabs))

    def probe(*a):
        return _capacity_probe(
            *a, K, 2, False, grid, None, None, None, None, None, W, 0,
            emit_plan=False,
        )[:2]

    out.append(row(f"probe program, {nchr} chromosomes",
                   timed(probe, *args, reps=3), nbytes, copy_bps))
    return out


def dense_stages(n: int, snps: int, nchr: int, copy_bps: float,
                 mut_rate: float = 0.0) -> list:
    from geneevolve_tpu.dense.backend import _gamete_plans, _reproduce_planes
    from geneevolve_tpu.dense.packed import PackedConfig

    chr_len = -(-snps // 32) * 32
    m = nchr * chr_len
    L = 3.24
    cfg = PackedConfig(
        n=n, m=m, n_chr=nchr, xo_cap=int(8 + np.ceil(L + 6 * np.sqrt(L))),
        mut_rate=mut_rate, mut_cap=8, ncv=0,
    )
    hap = jax.random.bits(jax.random.key(0), (n, 2, m // 32), jnp.uint32)
    fa = jax.random.randint(jax.random.key(1), (n,), 0, n)
    mo = jax.random.randint(jax.random.key(2), (n,), 0, n)
    cdf = jnp.asarray(np.linspace(0.0, 37.0, m, dtype=np.float32))
    mut_cdf = cdf if mut_rate > 0 else None
    plan = _gamete_plans(jax.random.key(3), cdf, mut_cdf, cfg)

    def step(kernels):
        return lambda h, a, b: _reproduce_planes(
            h, a, b, *plan, cfg=cfg, kernels=kernels
        )

    return ab_rows("dense meiosis" + (" + mutations" if mut_rate else ""),
                   6 * n * m // 8, copy_bps, step(False), step(True),
                   hap, fa, mo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_probe", type=int, default=300_000)
    ap.add_argument("--n_dense", type=int, default=100_000)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_roofline: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip()
    copy_bps = copy_rate(4 << 30)
    stages = []
    for rows in (
        lambda: probe_stages(args.n_probe, 22, copy_bps),
        lambda: dense_stages(args.n_dense, 14_588, 22, copy_bps),
        lambda: dense_stages(args.n_dense, 14_588, 22, copy_bps, mut_rate=2.0),
    ):
        new = rows()
        stages += new
        print(json.dumps(new), file=sys.stderr, flush=True)
    res = {"card": card, "device_kind": dev.device_kind,
           "copy_GBps": copy_bps / 1e9, "stages": stages}
    line = json.dumps(res)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
