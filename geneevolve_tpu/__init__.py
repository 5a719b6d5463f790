"""geneevolve-tpu: a forward-in-time whole-genome simulator in JAX.

Capabilities mirror GeneEvolve (Tahmasbi & Keller, Bioinformatics 2017;
reference C++ at /root/reference) re-designed for JAX/XLA: vectorized
segment-ledger evolution, dense bit-packed meiosis, and a 2-D
(individuals x loci) device mesh. It runs on NVIDIA GPUs, and on the CPU
for tests.
"""

__version__ = "0.1.0"

from geneevolve_tpu.config import ScenarioConfig, PopulationConfig, PhenotypeConfig

__all__ = [
    "ScenarioConfig",
    "PopulationConfig",
    "PhenotypeConfig",
    "__version__",
]
