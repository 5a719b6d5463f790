"""chip_smoke.py's phases and checks, run here at toy sizes on the CPU (the
script itself refuses to run without a GPU)."""

import jax
import pytest

import chip_smoke as cs

SEG = dict(pop_size=300, n0=100, nchr=3, ncv=10, gens=3)
PAINT = dict(pop_size=60, n0=30, nchr=1, ncv=10, gens=2, snps=500)
DENSE = dict(pop_size=200, n0=40, nchr=3, ncv=10, gens=3, snps=300)


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "no GPU" in out.err


def test_segment_phase_and_determinism(tmp_path):
    first = cs.phase_segment(str(tmp_path), 5, SEG)
    assert abs(first["var_a0"] - first["oracle"]) <= 1e-4 * first["oracle"]
    assert any(k.endswith(".int") for k in first["digests"])
    cs.phase_determinism(str(tmp_path), 5, SEG, first)


def test_paint_phase(tmp_path):
    cs.phase_paint(str(tmp_path), 6, PAINT, n_check=20)


def test_dense_phase_checks_meiosis_and_precision(tmp_path):
    cs.phase_dense(str(tmp_path), 7, DENSE)


def test_checks_fail_loudly(tmp_path):
    """A corrupted output makes the phase's check raise."""
    first = cs.phase_segment(str(tmp_path), 5, SEG)
    other = dict(first["digests"])
    k = next(k for k in other if k.endswith(".summary"))
    other[k] = "0" * 64
    with pytest.raises(cs.SmokeError):
        cs.compare_outputs(first["digests"], other, "corrupted")


def test_four_card_paths_on_virtual_devices(tmp_path):
    """`run_four` on four CPU devices: deme migrations equal the recomputed
    exchange; --mesh runs equal the one-device runs byte for byte."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cs.run_four(str(tmp_path), 8, seg=SEG, dense=DENSE)


def test_kernel_phase(tmp_path):
    """Phase 5 at toy sizes: stage forms bit-equal, end-to-end outputs
    identical with the kernel off and on (both lower to XLA here)."""
    w = str(tmp_path)
    cs.phase_dense(w, 7, DENSE, oracle=False)
    cs.phase_kernels(w, 7, dict(DENSE, pop_size=64))
