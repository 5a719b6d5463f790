"""Device-mesh sharding: (individuals x loci) 2-D device mesh.

individuals = data-parallel axis (children, mating draws, phenotype rows);
loci = sequence-parallel analog (founder columns, maps, meiosis gathers).
Collectives (allele-frequency psum, parent-row gathers, migration permutes)
are inserted by XLA from sharding annotations.
"""

from geneevolve_tpu.parallel.mesh import (  # noqa: F401
    make_deme_step,
    make_mesh,
    make_sharded_step,
    shard_state,
)
