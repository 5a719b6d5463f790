"""Dense (individuals x loci) engine.

Population haplotypes live as a sharded `(2n, m)` uint8 array; each
generation is a crossover-phase select over parent rows plus a mutation XOR
and a phenotype matrix product. This is the HBM-bandwidth-bound path the
benchmark measures; the segment engine (`core/`) is the m-independent parity
path.
"""

from geneevolve_tpu.dense.step import DenseConfig, init_state, make_step  # noqa: F401
