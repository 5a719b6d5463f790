"""Checks that only mean something on the card: XLA:GPU's lowering of the
hot stages against the CPU backend, and full float32 precision in the
phenotype product. Marked `gpu`; they skip on the CPU. Run them on the
card in one process:

    GE_TEST_GPU=1 python -m pytest -m gpu -p no:xdist tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


def _on_cpu(fn, *args):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return np.asarray(fn(*(jax.device_put(np.asarray(a), cpu)
                               for a in args)))


def test_phenotype_product_full_precision(gpu):
    """phenotype_from_cv on the card stays within 1e-5 of float64 (a TF32
    product errs by ~1e-3)."""
    from geneevolve_tpu.dense.packed import phenotype_from_cv

    rng = np.random.default_rng(0)
    cv = (rng.random((20_000, 2, 2200)) < 0.3).astype(np.uint8)
    eff = rng.normal(size=2200).astype(np.float32)
    got = np.asarray(phenotype_from_cv(jnp.asarray(cv), jnp.asarray(eff)))
    t = cv[:, 0].astype(np.float64) + cv[:, 1]
    want = (t - t.mean(axis=0)) @ eff.astype(np.float64)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_dense_meiosis_matches_cpu(gpu):
    from geneevolve_tpu.dense import packed as pk
    from geneevolve_tpu.dense.step import _sample_gamete_plan

    cfg = pk.PackedConfig(n=4096, m=22 * 14_592, n_chr=22, xo_cap=22,
                          mut_rate=2.0, mut_cap=8)
    ks = jax.random.split(jax.random.key(3), 4)
    hap = jax.random.bits(ks[0], (cfg.n, 2, cfg.mw), jnp.uint32)
    par = jax.random.randint(ks[1], (cfg.n,), 0, cfg.n)
    xo, st, _ = _sample_gamete_plan(ks[2], cfg.as_dense(), cfg.n)
    mu, _ = pk.mutation_positions(ks[3], cfg.n, cfg)

    def f(h, p, x, s, m):
        return pk.apply_mutations_packed(pk.meiose_packed_xla(h, p, x, s, cfg), m)

    got = np.asarray(jax.jit(f)(hap, par, xo, st, mu))
    np.testing.assert_array_equal(got, _on_cpu(f, hap, par, xo, st, mu))


def test_probe_count_matches_cpu(gpu):
    from geneevolve_tpu.core import segments

    rng = np.random.default_rng(1)
    n, S, K = 50_000, 37, 22
    big = segments._big()
    st = np.full((n, 2, S), big, np.int32)
    st[..., :9] = np.sort(rng.integers(1, 10**8, (n, 2, 9)), -1)
    st[..., 0] = 0
    xo = np.full((n, K), big, np.int32)
    xo[:, :4] = np.sort(rng.integers(1, 10**8, (n, 4)), -1)
    xo[:, 4] = st[:, 0, 3]  # a crossover exactly on a boundary
    xo.sort(axis=1)
    sh = rng.integers(0, 2, n).astype(np.int32)
    got = np.asarray(jax.jit(segments.count_merge_valid)(st, xo, sh))
    np.testing.assert_array_equal(
        got, _on_cpu(segments.count_merge_valid, st, xo, sh)
    )


def test_kernels_match_xla_on_card(gpu):
    """The Triton meiosis kernel, compiled for the card, equals its XLA
    form."""
    from geneevolve_tpu.dense import backend
    from geneevolve_tpu.dense import packed as pk
    from geneevolve_tpu.dense.step import _sample_gamete_plan

    cfg = pk.PackedConfig(n=2048, m=22 * 14_592, n_chr=22, xo_cap=22,
                          mut_rate=2.0, mut_cap=8)
    ks = jax.random.split(jax.random.key(5), 6)
    hap = jax.random.bits(ks[0], (cfg.n, 2, cfg.mw), jnp.uint32)
    fa = jax.random.randint(ks[1], (cfg.n,), 0, cfg.n)
    mo = jax.random.randint(ks[2], (cfg.n,), 0, cfg.n)
    xo_p, st_p, _ = _sample_gamete_plan(ks[3], cfg.as_dense(), cfg.n)
    xo_m, st_m, _ = _sample_gamete_plan(ks[4], cfg.as_dense(), cfg.n)
    mu = jnp.stack([pk.mutation_positions(ks[5], cfg.n, cfg)[0]] * 2, axis=1)
    args = (hap, fa, mo, xo_p, st_p, xo_m, st_m, mu)
    got, want = (
        np.asarray(backend._reproduce_planes(*args, cfg=cfg, kernels=k))
        for k in (True, False)
    )
    np.testing.assert_array_equal(got, want)
