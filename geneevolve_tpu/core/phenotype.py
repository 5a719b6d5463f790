"""Phenotype construction: A/D from CV genotypes (device, elementwise sums),
scaling / E / F / C / P assembly, mating & selection values, selection
functions, and the cross-population gamma effect.

Formulas match the reference exactly:
- A/D (`/root/reference/src/Simulation.cpp:2624-2749`): with per-CV allele
  frequency p recomputed from the current generation, t in {0,1,2},
  alpha = a + d(q-p):  A = sum (t - 2p) alpha,  D = sum c_t d  with
  c_t = (-2p^2, 2pq, -2q^2); d forced to 0 when vd == 0.
- scaling (`Simulation.cpp:3075-3206`): A scaled by sqrt(varA_gen0/va)
  (frozen gen-0 variance; va == -1 means no scaling), likewise D; E drawn
  N(0,1) and rescaled by its own *empirical* sd to hit ve each generation;
  F is N(0, vf) at gen 0 and beta*(F_father + F_mother) after, with the
  transmitted quantity the parents' phenotype (vt_type 1) or parental effect
  (vt_type 2); P = A + D + C + E + F.
- MV/SV + selection (`Simulation.cpp:3300-3428`): MV = sum omega_j P_j,
  SV = sum lambda_j P_j standardized to gen-0 moments; selection probability
  1 at gen 0, then logit / probit / stab / thr.
- gamma (`Simulation.cpp:3254-3297, 3345-3381, 35-63`): solve
  var(P + b_i) = (1 + gamma) var(P) by Newton-Raphson for the offset scale,
  with b_i = a * (2i // (npop-1) - 1) — the reference uses C++ *integer*
  division here; we reproduce that.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------- device side
@jax.jit
def additive_dominance_chr(
    c0: jax.Array,  # (n, ncv) uint8 paternal-chromatid CV alleles
    c1: jax.Array,  # (n, ncv) maternal
    a0: jax.Array,  # (n, ncv) additive effect seen by chromatid 0 (root pop's)
    a1: jax.Array,
    d0: jax.Array,
    d1: jax.Array,
    dominance_on: jax.Array,  # () bool — False when vd == 0
    n_real=None,  # () int — rows >= n_real are mesh padding, excluded
    tsum=None,  # optional (ncv,) int32 GLOBAL allele counts: when the
    # individuals axis is processed in chunks, the frequency must come
    # from the whole population, not the chunk
    n_freq=None,  # () int — population size the counts were taken over
) -> Tuple[jax.Array, jax.Array]:
    """One chromosome's (A, D) contribution for every individual."""
    t = (c0 + c1).astype(jnp.float32)  # (n, ncv) in {0,1,2}
    n = c0.shape[0]
    if n_real is None:
        n_real = n
    if tsum is None:
        # integer allele-count sum: exact, hence bit-identical under any
        # individuals-axis sharding (a float32 psum would reassociate);
        # padding rows (index >= n_real) are masked out of the frequency
        valid = jnp.arange(n) < n_real
        tsum = jnp.sum(
            jnp.where(valid[:, None], (c0 + c1).astype(jnp.int32), 0), axis=0
        )
        n_freq = n_real
    nr = jnp.asarray(n_freq, dtype=jnp.float32)
    p = tsum.astype(jnp.float32) / (2.0 * nr)  # current-gen allele freq
    q = 1.0 - p
    a = 0.5 * (a0 + a1)
    d = jnp.where(dominance_on, 0.5 * (d0 + d1), 0.0)
    alpha = a + d * (q - p)[None, :]
    A = jnp.sum((t - 2.0 * p[None, :]) * alpha, axis=1)
    c_t = jnp.where(
        t == 0.0,
        -2.0 * p * p,
        jnp.where(t == 1.0, 2.0 * p * q, -2.0 * q * q),
    )
    D = jnp.sum(c_t * d, axis=1)
    return A, D


# ----------------------------------------------------------------- host side
def var(x: np.ndarray) -> float:
    """Sample variance, n-1 denominator (`CommFunc.cpp:57-68`)."""
    return float(np.var(np.asarray(x, dtype=np.float64), ddof=1)) if len(x) > 1 else 0.0


def scale_components(
    A_raw: np.ndarray,
    D_raw: np.ndarray,
    e_std: np.ndarray,  # N(0,1) draws
    par_eff: np.ndarray,  # raw parental effect (already beta-weighted, or gen-0 draws)
    C: np.ndarray,
    va: float,
    vd: float,
    ve: float,
    vf: float,
    var_a_gen0: float,
    var_d_gen0: float,
) -> dict:
    s_a = np.sqrt(var_a_gen0 / va) if va > 0 else 1.0
    if vd > 0:
        s_d = np.sqrt(var_d_gen0 / vd)
    elif vd == -1:
        s_d = 1.0
    else:
        s_d = 0.0
    s_ev = np.sqrt(var(e_std) / ve) if ve > 0 else 0.0

    E = e_std / s_ev if s_ev > 0 else np.zeros_like(e_std)
    A = A_raw / s_a
    D = D_raw / s_d if s_d > 0 else np.zeros_like(D_raw)
    F = par_eff if vf > 0 else np.zeros_like(par_eff)
    G = A + D
    P = A + D + C + E + F
    return {"A": A, "D": D, "G": G, "C": C, "E": E, "F": F, "P": P}


def selection_prob(
    z: np.ndarray, gen: int, func: str, par1: float, par2: float
) -> np.ndarray:
    """Marriage probability from the standardized selection value."""
    if gen == 0:
        return np.ones_like(z)
    if func == "logit" or func == "":
        b0, b1 = (0.0, 1.0) if func == "" else (par1, par2)
        y = np.exp(b0 + b1 * z)
        return y / (1.0 + y)
    if func == "probit":
        from scipy.special import erf

        return 0.5 * (1.0 + erf((z - par1) / (np.sqrt(2) * par2)))
    if func == "stab":
        return (
            1.0 / (np.sqrt(2 * np.pi) * par2)
            * np.exp(-0.5 * ((z - par1) / par2) ** 2)
        )
    if func == "thr":
        return np.where(z <= par2, par1, 1.0)
    return np.ones_like(z)


def mating_selection_values(
    P: np.ndarray,  # (npheno, n)
    omega: np.ndarray,  # (npheno,)
    lam: np.ndarray,  # (npheno,)
) -> Tuple[np.ndarray, np.ndarray]:
    mv = omega @ P
    sv = lam @ P
    return mv, sv


def gamma_offsets(n_pop: int, a: float) -> np.ndarray:
    """b_i = a * (2i // (n_pop-1) - 1), reproducing the reference's C++
    integer division (`Simulation.cpp:3269,3289`)."""
    i = np.arange(n_pop)
    return a * ((2 * i) // (n_pop - 1) - 1).astype(np.float64)


def pop_moments(x) -> tuple:
    """(n, sum, sumsq) of one population's phenotype vector, float64."""
    x = np.asarray(x, dtype=np.float64)
    return float(x.shape[0]), float(x.sum()), float((x * x).sum())


def solve_gamma_offset_moments(
    moments: list, gamma: float, x0: float = 10.0, precision: float = 1e-4
) -> float:
    """Newton-Raphson for the offset scale `a` s.t.
    var(concat(P_i + b_i)) = (1+gamma) var(concat(P_i)), from per-pop
    sufficient moments only: var(concat(P_i + b_i)) is closed-form in
    (n_i, sum_i, sumsq_i), so the cross-population reduction is three
    scalars per population — computed as one device psum under a mesh
    (SURVEY §2.4 'gamma-effect all-reduce') — and the NR scalar iteration
    stays host-side."""
    n_pop = len(moments)
    N = sum(m[0] for m in moments)

    def var_with(b) -> float:
        s = sum(m[1] + m[0] * b[i] for i, m in enumerate(moments))
        ss = sum(
            m[2] + 2.0 * b[i] * m[1] + m[0] * b[i] * b[i]
            for i, m in enumerate(moments)
        )
        return (ss - s * s / N) / (N - 1.0)

    s2x = var_with([0.0] * n_pop)

    def f(a: float) -> float:
        return var_with(gamma_offsets(n_pop, a)) - (1.0 + gamma) * s2x

    dx = 1e-3
    a = x0
    for _ in range(200):
        fa = f(a)
        fp = (f(a + dx) - f(a - dx)) / (2 * dx)
        if fp == 0:
            break
        a = a - fa / fp
        if abs(f(a)) < precision:
            return a
    return a


def solve_gamma_offset(
    phen_pops: list, gamma: float, x0: float = 10.0, precision: float = 1e-4
) -> float:
    """Newton-Raphson for the offset scale `a` s.t.
    var(concat(P_i + b_i)) = (1+gamma) var(concat(P_i))."""
    return solve_gamma_offset_moments(
        [pop_moments(p) for p in phen_pops], gamma, x0, precision
    )
