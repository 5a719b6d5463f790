"""The GPU meiosis kernel (`geneevolve_tpu/ops/`, Pallas on the Triton
backend) against its XLA formulation, in interpret mode on the CPU; the
XLA probe count (`segments.count_merge_valid`) against an interval-walk
oracle; and the choice between kernel and XLA when the dense step is
lowered for CUDA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geneevolve_tpu.core import segments
from geneevolve_tpu.dense import backend
from geneevolve_tpu.dense import packed as pk
from geneevolve_tpu.dense.step import _sample_gamete_plan
from geneevolve_tpu.ops.meiosis_triton import meiose_packed_triton

BIG = segments._big()


def _meiosis_inputs(chr_len, n_chr, n, N, mut):
    cfg = pk.PackedConfig(n=n, m=n_chr * chr_len, n_chr=n_chr, xo_cap=6,
                          mut_rate=3.0, mut_cap=5)
    ks = jax.random.split(jax.random.key(chr_len + n), 7)
    hap = jax.random.bits(ks[0], (N, 2, cfg.mw), jnp.uint32)
    fa = jax.random.randint(ks[1], (n,), 0, N)
    mo = jax.random.randint(ks[2], (n,), 0, N)
    xo_p, st_p, _ = _sample_gamete_plan(ks[3], cfg.as_dense(), n)
    xo_m, st_m, _ = _sample_gamete_plan(ks[4], cfg.as_dense(), n)
    mu = None
    if mut:
        mu = jnp.stack([pk.mutation_positions(ks[5], n, cfg)[0],
                        pk.mutation_positions(ks[6], n, cfg)[0]], axis=1)
    return cfg, (hap, fa, mo, xo_p, st_p, xo_m, st_m, mu)


@pytest.mark.parametrize("chr_len,n_chr,n,N,mut", [
    (14_592, 3, 37, 50, True),   # Table 3.1 chromosome width, 2 word blocks
    (96, 4, 20, 9, False),       # chromosomes narrower than a word block
    (32 * 129, 2, 33, 40, True),  # a block straddles two chromosomes
    (4096, 1, 16, 16, True),     # one chromosome, rows = one block
])
def test_meiosis_kernel_matches_xla(chr_len, n_chr, n, N, mut):
    cfg, args = _meiosis_inputs(chr_len, n_chr, n, N, mut)
    want = pk.make_reproduce(cfg)(*args)
    got = meiose_packed_triton(*args, chr_len=chr_len, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _ledger(rng, N, S, live, span=30_000):
    st = np.full((N, 2, S), BIG, np.int32)
    st[..., :live] = np.sort(rng.integers(1, span, (N, 2, live)), -1)
    st[..., 0] = 0
    return st


def _crossovers(rng, n, K, span=30_000):
    xo = np.full((n, K), BIG, np.int32)
    c = rng.integers(0, K + 1, n)
    for i in range(n):
        xo[i, : c[i]] = np.sort(rng.integers(0, span, c[i]))
    return xo


def _count_oracle(st, xo, start):
    """Interval walk: between consecutive crossovers the gamete copies one
    chromatid, alternating from `start`; a parent boundary (slot > 0)
    survives iff it lies in an interval copying its chromatid."""
    out = []
    for row, x, s in zip(st, xo, start):
        x = np.sort(x[x < BIG])
        edges = np.concatenate([[-1], x, [BIG + 1]])
        kept = 0
        for h in range(2):
            for b in row[h, 1:][row[h, 1:] < BIG]:
                j = np.searchsorted(edges, b, side="right") - 1
                kept += (s + j) % 2 == h
        out.append(1 + len(x) + kept)
    return np.array(out)


@pytest.mark.parametrize("N,n,S,K,live", [
    (300, 500, 37, 22, 9), (40, 33, 8, 3, 5), (100, 64, 16, 9, 16),
])
def test_count_kernel_matches_xla_and_oracle(N, n, S, K, live):
    rng = np.random.default_rng(N + n)
    st = _ledger(rng, N, S, live)
    xo = _crossovers(rng, n, K)
    par = rng.integers(0, N, n).astype(np.int32)
    # crossovers exactly on parent slot boundaries exercise the <= parity
    xo[:, -1] = st[par, rng.integers(0, 2, n), rng.integers(1, live, n)]
    sh = rng.integers(0, 2, n).astype(np.int32)
    want = _count_oracle(st[par], xo, sh)
    xla = segments.count_merge_valid(
        jnp.asarray(st)[par], jnp.asarray(xo), jnp.asarray(sh)
    )
    np.testing.assert_array_equal(np.asarray(xla), want)
    got = jax.jit(segments.count_merge_valid)(
        jnp.asarray(st)[par], jnp.asarray(xo), jnp.asarray(sh)
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def _cuda_text(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("kernels", [False, True])
def test_kernel_chosen_only_for_cuda_unsharded(kernels):
    """With `kernels`, the CUDA lowering of the dense step calls the
    Triton kernel and the CPU run takes the XLA formulation with the same
    result; without it (a sharded run) both lower to XLA."""
    cfg, args = _meiosis_inputs(96, 2, 8, 8, True)
    step = lambda *a: backend._reproduce_planes(*a, cfg=cfg, kernels=kernels)
    assert ("xla.gpu.triton" in _cuda_text(step, *args)) == kernels
    np.testing.assert_array_equal(
        np.asarray(step(*args)), np.asarray(pk.make_reproduce(cfg)(*args))
    )
