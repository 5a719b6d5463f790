"""Drop-in CLI: accepts the reference GeneEvolve flag set
(`/root/reference/src/Main.cpp:124-199`) so the Examples.zip scenario scripts
run unmodified against this engine.

    python -m geneevolve_tpu --file_gen_info ... --file_hap_name ... [flags]
"""

from __future__ import annotations

import os
import sys
import time

from geneevolve_tpu.config import ConfigError, parse_args, print_config

_HELP = """geneevolve-tpu — forward-time whole-genome simulator in JAX

 A fast and memory efficient forward-time simulator of whole-genome data:
 complex evolutionary scenarios with individual-level phenotypes and
 realistic whole-genome sequence or SNP data — mating systems, selection,
 population size and structure, migration, recombination, mutation, and
 environmental effects. Flag-compatible with GeneEvolve
 (`/root/reference/src/Main.cpp:124-199`); the Examples.zip scenario
 scripts run unmodified.

 -----------------------------------------------------------------------
                 geneevolve-tpu - List of Usage Options
 -----------------------------------------------------------------------

 --------- Population information
        --file_gen_info          : [filename]
          Generation schedule, one line per generation with columns
          pop_size mat_cor offspring_dist(p|f) selection_func(logit|
          probit|stab|thr|no) and its 2 parameters.
        --file_hap_name          : [filename]
          Per-chromosome SHAPEIT .hap/.legend/.indv address list.
        --file_ref_vcf           : [filename]
          Per-chromosome phased-VCF address list (wins if both given).
        --file_recom_map         : [filename]
        --file_mutation_map      : [filename]
        --RM                     : [off]  ->  Random Mating
        --MM                     : [0]
          Percentage of individuals with more than 1 spouse (0<=MM<=1).
        --vt_type                : [1]
          Vertical transmission: 1 = parents' phenotype, 2 = parents' F.
        --next_population        :
          This keyword separates consecutive populations' option sets.

 --------- Phenotypes (each flag repeatable, one per phenotype)
        --file_cv_info           : [filename]  (chr pos a d per CV)
        --file_cvs               : [filename]  (founder CV hap addresses)
        --va                     : [-1]   ->  variance of additive effect
                                   (-1 means no variance transform)
        --vd                     : [-1]   ->  variance of dominance effect
                                   (-1 means no variance transform)
        --vc                     : [0]    ->  variance of sibling (common) effect
        --ve                     : [1]    ->  variance of environment effect
        --vf                     : [0]    ->  variance of familial effect
        --omega                  : [1]    ->  coefficient for mating value
        --lambda                 : [1]    ->  coefficient for selection value
        --beta                   : [1]    ->  coefficient for familial effect

 --------- Immigration parameters
        --file_migration         : [filename]  (row-stochastic n_pop^2 matrix
          per generation; required when more than one population)

 --------- Environmental effects specific to each population (per phenotype)
        --gamma                  : [0]

 --------- Output parameters
        --out_hap                : [Off]  ->  [On] output in the [hap] format
        --out_plink              : [Off]  ->  [On] output in the [plink] format
        --out_plink01            : [Off]  ->  [On] output in the [plink01] format
        --out_vcf                : [Off]  ->  [On] output in the [vcf] format
        --out_interval           : [Off]  ->  [On] output in the [interval] format
        --file_output_generations: [filename]
          List of generations to write genotypes for, one per line.
        --no_output              : accepted for Examples.zip compatibility

 --------- Other parameters
        --prefix                 : [out]
        --avoid_inbreeding       : [Off]  ->  [On] means no inbreeding
        --seed                   : [0]    ->  any positive number (0 = clock)
        --debug                  : [Off]

 --------- Extensions (not in the reference)
        --mesh auto|ind=N[,loci=M] : shard the run over a device mesh
          (outputs bit-identical to the single-device run)
        --backend segment|dense  : genome engine (dense = materialized
          bit-packed planes, single population, highest throughput)
        --device_mating          : mate pairing on device (XLA collectives)
        --checkpoint_every <n> / --resume <prefix>.ckpt.npz
        --profile <dir>          : jax.profiler trace of the main loop
        --stage_sync             : wait for the device after each stage so
          the per-stage timing table is device-true (profiling only)
"""


CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where XLA compilations persist across runs: `JAX_COMPILATION_CACHE_DIR`
    when set, else the fixed `<checkout>/.jax_cache` (a fixed path, so a
    later process finds what an earlier one compiled)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across runs; opt out with
    GE_NO_COMPILE_CACHE=1. With `JAX_COMPILATION_CACHE_DIR` set, JAX reads
    it itself and nothing is set here."""
    if os.environ.get("GE_NO_COMPILE_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or any(a in ("--help", "-h", "?") for a in argv):
        print(_HELP)
        return 0
    t0 = time.time()
    try:
        cfg = parse_args(argv)
    except ConfigError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print_config(cfg)
    _enable_compilation_cache()
    from geneevolve_tpu.parallel.multihost import maybe_init_distributed

    maybe_init_distributed()  # no-op unless a coordinator is configured
    if cfg.backend == "dense":
        from geneevolve_tpu.dense.backend import DenseSimulation as Sim
    else:
        from geneevolve_tpu.core.engine import Simulation as Sim  # defer jax init

    mesh = None
    if cfg.mesh:
        from geneevolve_tpu.config import build_mesh

        mesh = build_mesh(cfg.mesh)
        print(
            f" Device mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}"
            f" on {mesh.devices.size} x {mesh.devices.flat[0].platform}"
        )
    sim = Sim(cfg, mesh=mesh)
    sim.run()
    print(f" Total time: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
