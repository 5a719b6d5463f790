"""Mate pairing and offspring assignment (host-side numpy).

Pairing is O(n log n) scalar work over at most a few million mating values
(~MBs), so it runs on host while the genome work runs on device — the
device-side cost is the parent-row gather that follows.

Semantics follow the reference:
- `random_mate` (`/root/reference/src/Simulation.cpp:2090-2157`): selection
  gate `U < selection_value_func`, then `pop_size` couples drawn uniformly
  with replacement from the marriageable of each sex, one child per couple.
- `assort_mate` (`Simulation.cpp:2167-2360`): selection gate; optional
  double-spouse duplication (MM); trim the larger sex at random; sort both
  sexes by mating value; draw an MVN(0, [[1,r],[r,1]]) template and match
  ranks; inbreeding veto via shared parent/grandparent IDs; offspring counts
  Poisson(pop_size/eligible-couples) or fixed+remainder.

The "p" offspring law draws the realized generation size N ~ Poisson(sum of
per-couple rates) = Poisson(pop_size) first, then assigns couples
multinomially — exactly the reference's independent per-couple
Poisson(pop_size/eligible) draws (`Simulation.cpp:2329-2337`), by the
standard conditioning identity. The engine keeps compiled shapes stable
under the resulting size jitter by padding genome planes with headroom and
reusing the parents' plane rows (see `Simulation._reproduce`).
`exact_n=True` (GE_EXACT_N=1) conditions on N = pop_size instead — the
jitter-free law documented in DESIGN.md.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class MatingError(RuntimeError):
    pass


@dataclass
class MatingPlan:
    father_pos: np.ndarray  # (n_couples,) positions in the parent population
    mother_pos: np.ndarray  # (n_couples,)
    inbred: np.ndarray  # (n_couples,) bool
    child_couple: np.ndarray  # (n_children,) couple index per child

    @property
    def n_couples(self) -> int:
        return len(self.father_pos)

    @property
    def child_father(self) -> np.ndarray:
        return self.father_pos[self.child_couple]

    @property
    def child_mother(self) -> np.ndarray:
        return self.mother_pos[self.child_couple]

    def couple_cor_mating_value(self, mating_value: np.ndarray) -> float:
        a = mating_value[self.father_pos]
        b = mating_value[self.mother_pos]
        if len(a) < 2 or a.std() == 0 or b.std() == 0:
            return float("nan")
        return float(np.corrcoef(a, b)[0, 1])


def random_mate(
    rng: np.random.Generator,
    selection_prob: np.ndarray,
    sex: np.ndarray,
    pop_size: int,
) -> MatingPlan:
    n = len(sex)
    marriageable = rng.random(n) < selection_prob
    males = np.flatnonzero(marriageable & (sex == 1))
    females = np.flatnonzero(marriageable & (sex == 2))
    if len(males) == 0 or len(females) == 0:
        raise MatingError(
            f"no one can marry: males={len(males)}, females={len(females)}"
        )
    father = males[rng.integers(0, len(males), size=pop_size)]
    mother = females[rng.integers(0, len(females), size=pop_size)]
    return MatingPlan(
        father_pos=father,
        mother_pos=mother,
        inbred=np.zeros(pop_size, dtype=bool),
        child_couple=np.arange(pop_size),
    )


def assort_mate(
    rng: np.random.Generator,
    mating_value: np.ndarray,
    selection_prob: np.ndarray,
    sex: np.ndarray,
    pedigree: dict,  # keys: father, ff, fm, mf, mm -> (n,) id arrays
    mat_cor: float,
    mm_percent: float,
    avoid_inbreeding: bool,
    offspring_dist: str,
    pop_size: int,
    exact_n: bool = False,
) -> MatingPlan:
    n = len(sex)
    marriageable = rng.random(n) < selection_prob
    males = np.flatnonzero(marriageable & (sex == 1))
    females = np.flatnonzero(marriageable & (sex == 2))
    if mm_percent > 0:
        males = np.concatenate(
            [males, males[rng.random(len(males)) < mm_percent]]
        )
        females = np.concatenate(
            [females, females[rng.random(len(females)) < mm_percent]]
        )
    if min(len(males), len(females)) == 0:
        raise MatingError(
            f"couples=0: males={len(males)}, females={len(females)}"
        )
    # trim the larger sex at random so counts match (`Simulation.cpp:2233-2246`)
    nc = min(len(males), len(females))
    if len(males) > nc:
        males = rng.permutation(males)[: nc]
    if len(females) > nc:
        females = rng.permutation(females)[: nc]
    # order by mating value, rank-match through a correlated template
    males = males[np.argsort(mating_value[males], kind="stable")]
    females = females[np.argsort(mating_value[females], kind="stable")]
    cov = np.array([[1.0, mat_cor], [mat_cor, 1.0]])
    t = rng.multivariate_normal(np.zeros(2), cov, size=nc)
    rank1 = np.argsort(np.argsort(t[:, 0], kind="stable"), kind="stable")
    rank2 = np.argsort(np.argsort(t[:, 1], kind="stable"), kind="stable")
    father = males[rank1]
    mother = females[rank2]

    if avoid_inbreeding:
        # sibs share a father; cousins share any grandparent
        # (`Simulation.cpp:2304-2320`)
        sib = pedigree["father"][father] == pedigree["father"][mother]
        cousin = np.zeros(nc, dtype=bool)
        for a in ("ff", "mf"):  # grandfathers of the male vs of the female
            for b in ("ff", "mf"):
                cousin |= pedigree[a][father] == pedigree[b][mother]
        for a in ("fm", "mm"):  # grandmothers
            for b in ("fm", "mm"):
                cousin |= pedigree[a][father] == pedigree[b][mother]
        inbred = sib | cousin
    else:
        inbred = np.zeros(nc, dtype=bool)

    eligible = np.flatnonzero(~inbred)
    if len(eligible) == 0:
        raise MatingError("all couples vetoed as inbred")

    if offspring_dist in ("f", "F"):
        nf = pop_size // len(eligible)
        remainder = pop_size - nf * len(eligible)
        child_couple = np.repeat(eligible, nf)
        if remainder:
            extra = rng.permutation(eligible)[:remainder]
            child_couple = np.concatenate([child_couple, extra])
    else:
        # "p": independent Poisson(pop_size/eligible) per couple == draw
        # the realized total N ~ Poisson(pop_size), then assign couples
        # multinomially (`Simulation.cpp:2329-2337`). exact_n conditions
        # on N = pop_size (fixed-shape engines).
        realized = pop_size if exact_n else max(1, int(rng.poisson(pop_size)))
        child_couple = eligible[rng.integers(0, len(eligible), size=realized)]
    return MatingPlan(
        father_pos=father,
        mother_pos=mother,
        inbred=inbred,
        child_couple=child_couple,
    )
