"""tools/stage_roofline.py's stage builders run at toy sizes on the CPU
(the tool itself refuses to run without a GPU). On the CPU both forms of a
stage lower to XLA, so the kernel-vs-XLA equality check passes trivially
here; the kernel's own CPU tests run it in interpret mode."""

import pytest


@pytest.fixture(scope="module")
def roofline():
    from tools import stage_roofline

    return stage_roofline


def test_probe_stages_price_their_bytes(roofline):
    rows = roofline.probe_stages(n=512, nchr=3, copy_bps=1e9)
    assert [r["stage"] for r in rows] == [
        "probe count, 3 chromosomes", "probe program, 3 chromosomes"
    ]
    for r in rows:
        assert r["seconds"] > 0 and r["bytes"] > 0
        assert r["GBps"] == pytest.approx(r["bytes"] / r["seconds"] / 1e9)


@pytest.mark.parametrize("mut_rate", [0.0, 2.0])
def test_dense_stages_price_six_plane_passes(roofline, mut_rate):
    rows = roofline.dense_stages(n=64, snps=300, nchr=3, copy_bps=1e9,
                                 mut_rate=mut_rate)
    assert len(rows) == 2
    assert all(r["bytes"] == 6 * 64 * (3 * 320) // 8 for r in rows)


def test_main_refuses_without_gpu(roofline, capsys):
    assert roofline.main([]) == 1
    assert capsys.readouterr().out == ""
