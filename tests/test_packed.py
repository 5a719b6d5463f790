"""Bit-packed engine: equality with the byte engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geneevolve_tpu.dense import packed as pk
from geneevolve_tpu.dense.step import (
    DenseConfig,
    _meiose_xla,
    _sample_gamete_plan,
    init_state as dense_init,
    make_step as make_dense_step,
)


def _cfgs(**kw):
    base = dict(n=24, m=1024, n_chr=4, xo_cap=6, mut_rate=0.8, mut_cap=4, ncv=16)
    base.update(kw)
    pcfg = pk.PackedConfig(**base)
    return pcfg, pcfg.as_dense()


def test_pack_roundtrip():
    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, size=(5, 64), dtype=np.uint8))
    np.testing.assert_array_equal(
        np.asarray(pk.unpack_bits(pk.pack_bits(bits), 64)), np.asarray(bits)
    )


def test_packed_meiosis_equals_byte_engine():
    pcfg, dcfg = _cfgs()
    key = jax.random.key(0)
    dstate = dense_init(key, dcfg)
    pstate = pk.init_state(key, pcfg)
    np.testing.assert_array_equal(
        np.asarray(pk.unpack_bits(pstate["hap"][:, 0], pcfg.m)),
        np.asarray(dstate["hapA"]),
    )
    kf, kp = jax.random.split(jax.random.key(3))
    parent = jax.random.randint(kf, (pcfg.n,), 0, pcfg.n)
    xo, st, _ = _sample_gamete_plan(kp, dcfg, pcfg.n)
    ref = _meiose_xla(dstate["hapA"], dstate["hapB"], parent, xo, st, dcfg)
    got = pk.meiose_packed_xla(pstate["hap"], parent, xo, st, pcfg)
    np.testing.assert_array_equal(
        np.asarray(pk.unpack_bits(got, pcfg.m)), np.asarray(ref)
    )


def test_packed_step_equals_byte_step():
    pcfg, dcfg = _cfgs()
    key = jax.random.key(0)
    dstate = dense_init(key, dcfg)
    pstate = pk.init_state(key, pcfg)
    ds = jax.jit(make_dense_step(dcfg))(dstate, jax.random.key(5))
    ps = jax.jit(pk.make_step(pcfg))(pstate, jax.random.key(5))
    for plane, k in ((0, "hapA"), (1, "hapB")):
        np.testing.assert_array_equal(
            np.asarray(pk.unpack_bits(ps["hap"][:, plane], pcfg.m)),
            np.asarray(ds[k]),
        )


def test_packed_phenotype_matches():
    from geneevolve_tpu.dense.step import phenotype_additive

    pcfg, dcfg = _cfgs()
    dstate = dense_init(jax.random.key(1), dcfg)
    pstate = pk.init_state(jax.random.key(1), pcfg)
    a = phenotype_additive(
        dstate["hapA"], dstate["hapB"], dstate["cv_idx"], dstate["eff"]
    )
    b = pk.phenotype_additive_packed(
        pstate["hap"], pstate["cv_idx"], pstate["eff"]
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_packed_sharded_step_matches_single_device():
    from geneevolve_tpu.parallel import make_mesh, make_sharded_step, shard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    pcfg, _ = _cfgs(n=32, m=2048, selection=True, mut_rate=0.5)
    state = pk.init_state(jax.random.key(0), pcfg)
    key = jax.random.key(4)
    single = jax.jit(pk.make_step(pcfg))(state, key)
    mesh = make_mesh(jax.devices()[:8])
    sharded_in = shard_state(pk.init_state(jax.random.key(0), pcfg), mesh)
    out = make_sharded_step(pcfg, mesh)(sharded_in, key)
    np.testing.assert_array_equal(
        np.asarray(single["hap"]), np.asarray(out["hap"])
    )


def test_deme_step_isolates_shards():
    """Deme-mode sharded step runs; each individuals-shard evolves as an
    isolated deme (children carry only their own shard's founder alleles)."""
    from geneevolve_tpu.parallel import make_deme_step, make_mesh, shard_state

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(jax.devices()[:8])  # (4, 2) ind x loci
    ind_n = mesh.devices.shape[0]
    pcfg, _ = _cfgs(n=8 * ind_n, m=4096, n_chr=4, selection=True,
                    mut_rate=0.0)
    state = pk.init_state(jax.random.key(0), pcfg)
    # mark each deme's founders: deme d gets constant allele d & 1 in the
    # first word of every chromatid
    marker = np.repeat(
        ((np.arange(ind_n) & 1) * 0xFFFFFFFF).astype(np.uint32),
        pcfg.n // ind_n,
    )
    hap = np.array(state["hap"])
    hap[:, :, 0] = marker[:, None]
    state["hap"] = jnp.asarray(hap)
    state = shard_state(state, mesh)
    step = make_deme_step(pcfg, mesh)
    out = state
    for g in range(3):
        out = step(out, jax.random.key(g))
    got = np.asarray(out["hap"])[:, 0, 0]
    np.testing.assert_array_equal(got, marker)


def test_mutation_positions_apply_as_single_bit_flips():
    """Each non-pad mutation position flips exactly its own locus."""
    pcfg, _ = _cfgs(mut_rate=1.5, mut_cap=4)
    state = pk.init_state(jax.random.key(2), pcfg)
    key = jax.random.key(11)
    pos, _ = pk.mutation_positions(key, pcfg.n, pcfg)
    plane = state["hap"][:, 0]
    got = pk.apply_mutations_packed(plane, pos)
    before = np.asarray(pk.unpack_bits(plane, pcfg.m))
    after = np.asarray(pk.unpack_bits(got, pcfg.m))
    want = before.copy()
    for i, row in enumerate(np.asarray(pos)):
        for p in row:
            if p < pcfg.m:
                want[i, p] ^= 1
    np.testing.assert_array_equal(after, want)


@pytest.mark.parametrize("chr_len", [32 * 3, 32 * 129, 14_592])
def test_packed_meiosis_word_aligned_chromosomes(chr_len):
    """Chromosomes padded to whole 32-locus words only (the one padding
    unit): packed meiosis + mutation flips equal the byte engine at
    chromosome lengths that are multiples of 32 but not of 4096."""
    pcfg = pk.PackedConfig(
        n=12, m=2 * chr_len, n_chr=2, xo_cap=5, mut_rate=1.5, mut_cap=4,
        ncv=8,
    )
    dcfg = pcfg.as_dense()
    key = jax.random.key(chr_len)
    dstate = dense_init(key, dcfg)
    pstate = pk.init_state(key, pcfg)
    kf, kp, ku = jax.random.split(jax.random.key(9), 3)
    parent = jax.random.randint(kf, (pcfg.n,), 0, pcfg.n)
    xo, st, _ = _sample_gamete_plan(kp, dcfg, pcfg.n)
    mu, _ = pk.mutation_positions(ku, pcfg.n, pcfg)
    want = np.asarray(
        _meiose_xla(dstate["hapA"], dstate["hapB"], parent, xo, st, dcfg)
    ).copy()
    for i, row in enumerate(np.asarray(mu)):
        for p in row[row < pcfg.m]:
            want[i, p] ^= 1
    got = pk.apply_mutations_packed(
        pk.meiose_packed_xla(pstate["hap"], parent, xo, st, pcfg), mu
    )
    np.testing.assert_array_equal(
        np.asarray(pk.unpack_bits(got, pcfg.m)), want
    )


def test_resident_cv_matrix_tracks_planes():
    """The step maintains state['cv'] incrementally through meiosis; it must
    stay bitwise equal to re-extracting the CV columns from the packed
    planes, across generations, with selection and mutation on."""
    pcfg, _ = _cfgs(selection=True, mut_rate=2.0)
    state = pk.init_state(jax.random.key(3), pcfg)
    np.testing.assert_array_equal(
        np.asarray(state["cv"]),
        np.asarray(pk.cv_from_planes(state["hap"], state["cv_idx"])),
    )
    step = jax.jit(pk.make_step(pcfg))
    key = jax.random.key(4)
    for g in range(5):
        state = step(state, jax.random.fold_in(key, g))
        np.testing.assert_array_equal(
            np.asarray(state["cv"]),
            np.asarray(pk.cv_from_planes(state["hap"], state["cv_idx"])),
            err_msg=f"generation {g}",
        )


def test_phenotype_product_full_precision():
    """The selection phenotype's product asks for full float32 precision
    (no TF32 on a GPU's matrix unit) and matches float64 to 1e-5 of its
    largest value."""
    rng = np.random.default_rng(0)
    cv = (rng.random((3000, 2, 500)) < rng.random(500)).astype(np.uint8)
    eff = rng.normal(size=500).astype(np.float32)
    jaxpr = str(jax.make_jaxpr(pk.phenotype_from_cv)(cv, eff))
    assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in jaxpr
    got = np.asarray(pk.phenotype_from_cv(jnp.asarray(cv), jnp.asarray(eff)))
    t = cv[:, 0].astype(np.float64) + cv[:, 1]
    want = (t - t.mean(axis=0)) @ eff.astype(np.float64)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
