"""Routed panmictic sharded step (parallel/mesh.py make_routed_step):
request-routed parent fetches replace the parent-plane all-gather while
keeping the exact global-mating law (VERDICT r4 item 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geneevolve_tpu.dense.packed import PackedConfig, init_state, unpack_bits
from geneevolve_tpu.parallel import make_mesh, shard_state
from geneevolve_tpu.parallel.mesh import make_routed_step, routed_fetch

from jax import shard_map
from jax.sharding import PartitionSpec as P


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(jax.devices()[:8], (4, 2))


def test_routed_fetch_exact(mesh):
    """routed_fetch == direct table[idx] for arbitrary cross-shard
    requests (the all_to_all index/row round trip is a pure gather)."""
    rng = np.random.default_rng(0)
    tab = jnp.asarray(rng.integers(0, 1 << 20, size=(256, 3)), jnp.int32)
    idx = jnp.asarray(rng.integers(0, 256, size=64), jnp.int32)

    def f(tab_loc, idx_rep):
        return routed_fetch(tab_loc, idx_rep, 256 // 4, 4, cap=64)

    got, ov = jax.jit(
        shard_map(f, mesh=mesh, in_specs=(P("ind", None), P()),
                  out_specs=(P(), P()), check_vma=False)
    )(tab, idx)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(tab)[np.asarray(idx)])
    assert int(ov) == 0


def test_routed_fetch_skewed_requests(mesh):
    """All requests hitting ONE owner shard still resolve exactly when cap
    covers them (worst-case skew), and overflow is counted when not."""
    tab = jnp.arange(256 * 2, dtype=jnp.int32).reshape(256, 2)
    idx = jnp.asarray(np.full(40, 7), jnp.int32)  # all rows on shard 0

    def f(cap):
        def g(tab_loc, idx_rep):
            return routed_fetch(tab_loc, idx_rep, 64, 4, cap=cap)
        return jax.jit(
            shard_map(g, mesh=mesh, in_specs=(P("ind", None), P()),
                      out_specs=(P(), P()), check_vma=False)
        )(tab, idx)

    got, ov = f(64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(tab)[np.asarray(idx)])
    assert int(ov) == 0
    _, ov = f(8)  # 40 requests to one owner, cap 8 -> 32 dropped, counted
    assert int(ov) == 32


def test_routed_step_runs_and_keeps_law(mesh):
    """A few routed generations: allele frequencies stay interior, CV
    matrix stays in range, no capacity clips."""
    cfg = PackedConfig(
        n=256, m=8192 * 2, n_chr=4, morgans_per_chr=1.0, xo_cap=8,
        mut_rate=0.5, mut_cap=4, ncv=64, selection=True,
    )
    state = shard_state(init_state(jax.random.key(0), cfg), mesh)
    step = make_routed_step(cfg, mesh)
    out = state
    for g in range(3):
        out = step(out, jax.random.fold_in(jax.random.key(1), g))
    h = np.asarray(unpack_bits(out["hap"][:, 0], cfg.m))
    assert 0.05 < h.mean() < 0.95
    assert int(out["clip"]) == 0
    cvm = np.asarray(out["cv"])
    assert cvm.min() >= 0 and cvm.max() <= 1
