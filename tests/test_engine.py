"""End-to-end engine tests on a tiny synthetic scenario (fast), including
checkpoint/resume byte-identity."""

import filecmp
import os
from pathlib import Path

import numpy as np
import pytest

from geneevolve_tpu.config import parse_args
from geneevolve_tpu.core.engine import Simulation


def _run(root: Path, outdir: Path, extra=()):
    args = [
        "--file_gen_info", str(root / "popinfo.txt"),
        "--file_hap_name", str(root / "hap_address.txt"),
        "--file_recom_map", str(root / "rmap.txt"),
        "--file_cv_info", str(root / "cv.info"),
        "--file_cvs", str(root / "cv_address.txt"),
        "--seed", "777",
        "--prefix", str(outdir / "out"),
        *extra,
    ]
    cfg = parse_args(args)
    sim = Simulation(cfg, verbose=False)
    sim.run()
    return sim


def test_mini_run_outputs(mini_scenario, tmp_path):
    sim = _run(mini_scenario, tmp_path, ["--out_interval"])
    summary = (tmp_path / "out.pop1.summary").read_text().splitlines()
    assert len(summary) == 6  # header + gens 0..4
    hdr = summary[0].split()
    assert hdr[0] == "gen" and "ph1_var_A" in hdr
    # gen-0 scaling: var_E == ve == 1 at every generation
    for line in summary[1:]:
        vals = dict(zip(hdr, line.split()))
        assert abs(float(vals["ph1_var_E"]) - 1.0) < 1e-6
    for g in range(5):
        info = tmp_path / f"out.info.pop1.gen{g}.txt"
        assert info.exists()
        n_rows = len(info.read_text().splitlines()) - 1
        if g == 0:
            assert n_rows == 50  # founders are exact
        else:
            # realized size ~ Poisson(60) (`Simulation.cpp:2329-2337`)
            assert 25 <= n_rows <= 100, (g, n_rows)
    assert (tmp_path / "out.pop1.gen4.chr1.int").exists()


def test_same_seed_identical(mini_scenario, tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    _run(mini_scenario, d1)
    _run(mini_scenario, d2)
    assert filecmp.cmp(
        d1 / "out.pop1.summary", d2 / "out.pop1.summary", shallow=False
    )
    assert filecmp.cmp(
        d1 / "out.info.pop1.gen4.txt", d2 / "out.info.pop1.gen4.txt",
        shallow=False,
    )


def test_stage_sync_identical_and_timed(mini_scenario, tmp_path):
    """--stage_sync fences each device stage (device-true timing) without
    changing any result byte."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    _run(mini_scenario, d1)
    sim = _run(mini_scenario, d2, ["--stage_sync"])
    assert filecmp.cmp(
        d1 / "out.pop1.summary", d2 / "out.pop1.summary", shallow=False
    )
    assert filecmp.cmp(
        d1 / "out.info.pop1.gen4.txt", d2 / "out.info.pop1.gen4.txt",
        shallow=False,
    )
    assert sim.timer.totals["reproduce"] > 0
    assert sim.timer.totals["compute_ad"] > 0


def test_info_writer_error_surfaces(mini_scenario, tmp_path):
    """A failed background info-file write must raise, not vanish: the
    done-future pruning in _save_info re-raises stored exceptions."""
    sim = _run(mini_scenario, tmp_path)
    boom = RuntimeError("disk full")

    def _fail(*a, **k):
        raise boom

    sim._save_info_sync = _fail
    sim._save_info(sim.pops[0], 1)  # queues the failing write
    sim._io_pool.shutdown(wait=True)  # let it complete
    from concurrent.futures import ThreadPoolExecutor

    sim._io_pool = ThreadPoolExecutor(max_workers=1)
    with pytest.raises(RuntimeError, match="disk full"):
        sim._save_info(sim.pops[0], 2)


def test_checkpoint_resume_bit_identical(mini_scenario, tmp_path):
    from geneevolve_tpu.core import checkpoint

    straight = tmp_path / "straight"
    ck = tmp_path / "ck"
    straight.mkdir(), ck.mkdir()
    _run(mini_scenario, straight)

    # run only through gen 2, checkpointing, by saving at 2 and stopping
    cfg = parse_args([
        "--file_gen_info", str(mini_scenario / "popinfo.txt"),
        "--file_hap_name", str(mini_scenario / "hap_address.txt"),
        "--file_recom_map", str(mini_scenario / "rmap.txt"),
        "--file_cv_info", str(mini_scenario / "cv.info"),
        "--file_cvs", str(mini_scenario / "cv_address.txt"),
        "--seed", "777",
        "--prefix", str(ck / "out"),
    ])
    sim = Simulation(cfg, verbose=False)
    sim.init_generation0()
    for gen in (1, 2):
        sim.step(gen)
    checkpoint.save(sim, 2, str(ck / "out.ckpt.npz"))

    # fresh process-equivalent: new Simulation resuming from the checkpoint
    cfg2 = parse_args([
        "--file_gen_info", str(mini_scenario / "popinfo.txt"),
        "--file_hap_name", str(mini_scenario / "hap_address.txt"),
        "--file_recom_map", str(mini_scenario / "rmap.txt"),
        "--file_cv_info", str(mini_scenario / "cv.info"),
        "--file_cvs", str(mini_scenario / "cv_address.txt"),
        "--seed", "777",
        "--prefix", str(ck / "out"),
        "--resume", str(ck / "out.ckpt.npz"),
    ])
    sim2 = Simulation(cfg2, verbose=False)
    sim2.run()

    assert filecmp.cmp(
        straight / "out.pop1.summary", ck / "out.pop1.summary", shallow=False
    )
    for g in (3, 4):
        assert filecmp.cmp(
            straight / f"out.info.pop1.gen{g}.txt",
            ck / f"out.info.pop1.gen{g}.txt",
            shallow=False,
        )


def test_checkpoint_rejects_wrong_seed(mini_scenario, tmp_path):
    from geneevolve_tpu.core import checkpoint

    d = tmp_path / "x"
    d.mkdir()
    sim = _run(mini_scenario, d)
    checkpoint.save(sim, 4, str(d / "out.ckpt.npz"))
    cfg = parse_args([
        "--file_gen_info", str(mini_scenario / "popinfo.txt"),
        "--file_hap_name", str(mini_scenario / "hap_address.txt"),
        "--file_recom_map", str(mini_scenario / "rmap.txt"),
        "--file_cv_info", str(mini_scenario / "cv.info"),
        "--file_cvs", str(mini_scenario / "cv_address.txt"),
        "--seed", "778",
        "--prefix", str(d / "out2"),
    ])
    sim2 = Simulation(cfg, verbose=False)
    with pytest.raises(RuntimeError, match="seed"):
        checkpoint.load(sim2, str(d / "out.ckpt.npz"))


def test_donation_lands_at_constant_pop_size(tmp_path):
    """`_reproduce_all` donates the genome planes so the engine's peak HBM
    is ~2x (not 3x) state. Donation can only land when child shapes equal
    parent shapes — i.e. at constant population size (the one gen0->gen1
    resize in growth scenarios legitimately re-allocates). This guards the
    memory story: a silent 'donated buffers were not usable' regression
    at constant size would triple the 300k-scale footprint."""
    import sys as _sys
    import warnings

    _sys.path.insert(0, "/root/repo/tools")
    from mkscenario import make_scenario

    flags = make_scenario(
        str(tmp_path / "sc"), n0=200, pop_size=200, gens=3, nchr=3, ncv=12,
        offspring_dist="f",  # exact sizes: Poisson jitter would resize once
    )
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    cfg = parse_args(argv + ["--seed", "9", "--prefix", str(tmp_path / "o")])
    sim = Simulation(cfg, verbose=False)
    sim.init_generation0()
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "error", message=".*donated buffers were not usable.*"
        )
        for g in range(1, 4):
            sim.step(g)


def test_indv_hap_count_mismatch_fails_at_load(tmp_path):
    """A panel whose .indv count doesn't match the .hap columns must fail
    at load (`Simulation.cpp:290-320`), not at output time."""
    import sys as _sys

    _sys.path.insert(0, "/root/repo/tools")
    from mkscenario import make_scenario

    flags = make_scenario(
        str(tmp_path / "sc"), n0=30, pop_size=30, gens=2, nchr=2, ncv=4,
    )
    # corrupt chromosome 2's .indv: drop one id
    import re

    addr = (tmp_path / "sc" / "hap_address.txt").read_text().splitlines()
    indv_path = addr[1].split()[3]
    lines = open(indv_path).read().splitlines()
    with open(indv_path, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    cfg = parse_args(argv + ["--seed", "5", "--prefix", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="not equal"):
        Simulation(cfg, verbose=False)


def test_show_results_console_table(mini_scenario, tmp_path, capsys):
    """End-of-run `ras_show_res` table (`Simulation.cpp:704-780`)."""
    d = tmp_path / "x"
    d.mkdir()
    cfg = parse_args([
        "--file_gen_info", str(mini_scenario / "popinfo.txt"),
        "--file_hap_name", str(mini_scenario / "hap_address.txt"),
        "--file_recom_map", str(mini_scenario / "rmap.txt"),
        "--file_cv_info", str(mini_scenario / "cv.info"),
        "--file_cvs", str(mini_scenario / "cv_address.txt"),
        "--seed", "778",
        "--prefix", str(d / "out"),
    ])
    sim = Simulation(cfg, verbose=True)
    sim.run()
    out = capsys.readouterr().out
    assert " ---------- Population 1" in out
    assert " phenotype: 1" in out
    for label in ("   var_A:", "   var_P:", "   h2   :",
                  " var_mating_value   :", " var_selection_value:"):
        assert label in out, label


def test_chunked_ad_bit_identical(mini_scenario, tmp_path, monkeypatch):
    """Biobank-n A/D chunking (GE_AD_CHUNK): global integer allele counts
    in pass 1, per-chunk A/D against the global frequency in pass 2 —
    byte-identical outputs to the unchunked path."""
    monkeypatch.setenv("GE_NO_RESIDENT_CV", "1")  # force the _ad_all path
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    _run(mini_scenario, d1)
    monkeypatch.setenv("GE_AD_CHUNK", "16")  # ~5 chunks at n=60
    _run(mini_scenario, d2)
    assert filecmp.cmp(
        d1 / "out.pop1.summary", d2 / "out.pop1.summary", shallow=False
    )
    assert filecmp.cmp(
        d1 / "out.info.pop1.gen4.txt", d2 / "out.info.pop1.gen4.txt",
        shallow=False,
    )


def test_plan_per_group_bit_identical(mini_scenario, tmp_path, monkeypatch):
    """GE_PLAN_PER_GROUP=1 re-draws the generation plan per chromosome
    group just-in-time (biobank-n memory mode) — byte-identical outputs
    to the stacked plan-once path (shared _chr_plan_draws key schedule)."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    monkeypatch.setenv("GE_PLAN_PER_GROUP", "0")
    _run(mini_scenario, d1)
    monkeypatch.setenv("GE_PLAN_PER_GROUP", "1")
    _run(mini_scenario, d2)
    assert filecmp.cmp(
        d1 / "out.pop1.summary", d2 / "out.pop1.summary", shallow=False
    )
    assert filecmp.cmp(
        d1 / "out.info.pop1.gen4.txt", d2 / "out.info.pop1.gen4.txt",
        shallow=False,
    )


def test_resident_cv_hbm_budget_gate(mini_scenario, tmp_path, monkeypatch):
    """The resident-CV residency decision is HBM-budget-aware: with a
    budget too small for ledger state + CV matrix the engine falls back
    to the gather path automatically, with byte-identical outputs (the
    resident matrix is a pure caching layer, engine.py `_ad_resident`)."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    sim1 = _run(mini_scenario, d1)
    assert sim1.resident_cv  # default at mini scale
    monkeypatch.setenv("GE_HBM_BYTES", "4096")  # absurdly small budget
    sim2 = _run(mini_scenario, d2)
    assert not sim2.resident_cv  # gate engaged
    assert filecmp.cmp(
        d1 / "out.pop1.summary", d2 / "out.pop1.summary", shallow=False
    )
    assert filecmp.cmp(
        d1 / "out.info.pop1.gen4.txt", d2 / "out.info.pop1.gen4.txt",
        shallow=False,
    )


@pytest.mark.parametrize("stats,env,want", [
    ({"bytes_limit": 80 * 2**30, "bytes_in_use": 1}, None, 80 * 2**30),
    (None, None, None),  # the CPU backend reports no memory stats
    ({"bytes_in_use": 1}, None, None),
    (None, "4096", 4096),  # GE_HBM_BYTES overrides the device
])
def test_device_memory_budget(monkeypatch, stats, env, want):
    from geneevolve_tpu.core.engine import device_memory_budget

    if env is None:
        monkeypatch.delenv("GE_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("GE_HBM_BYTES", env)
    assert device_memory_budget(stats) == want


@pytest.mark.parametrize("limit,resident", [
    (None, True), (4096, False), (80 * 2**30, True),
])
def test_resident_cv_gate_from_device_limit(mini_scenario, tmp_path,
                                            monkeypatch, limit, resident):
    """The residency decision follows the device's bytes_limit; with no
    memory stats (CPU) no gate applies."""
    from geneevolve_tpu.core import engine

    monkeypatch.delenv("GE_HBM_BYTES", raising=False)
    monkeypatch.setattr(engine, "device_memory_budget", lambda stats: limit)
    cfg = parse_args([
        "--file_gen_info", str(mini_scenario / "popinfo.txt"),
        "--file_hap_name", str(mini_scenario / "hap_address.txt"),
        "--file_recom_map", str(mini_scenario / "rmap.txt"),
        "--file_cv_info", str(mini_scenario / "cv.info"),
        "--file_cvs", str(mini_scenario / "cv_address.txt"),
        "--prefix", str(tmp_path / "out"),
    ])
    assert Simulation(cfg, verbose=False).resident_cv == resident
