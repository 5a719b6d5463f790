"""Fused packed meiosis for NVIDIA GPUs (Pallas, Triton backend).

Computes what `dense/packed.make_reproduce` computes in XLA — both
gametes' word-mask meiosis (`meiose_packed_xla`) and the de novo mutation
flips (`apply_mutations_packed`) — in one pass: a program owns a block of
BR children x BW packed words of one gamete, loads the BR parent rows of
both chromatids once, builds the crossover phase mask in registers from
the child's crossover list, applies the mutation flips, and stores the
child words. Each parent word is read once and each child word written
once: 6 passes over n x m/8 bytes per generation, the dense engine's floor.

The crossover list is per (gamete, chromosome); a word block spans at most
two chromosomes (BW <= words per chromosome), so each element picks its
chromosome's crossover from two candidates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BR = 16  # children per program
BW_MAX = 128  # packed words per program
FULL = 0xFFFFFFFF


def _kernel(par_ref, xo_ref, st_ref, *refs, n, mw, cw, n_chr, K, Km, bw):
    if Km:
        mu_ref, hap_ref, out_ref = refs
    else:
        hap_ref, out_ref = refs
    i, j, g = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    r = i * BR + jnp.arange(BR, dtype=jnp.int32)
    rm = r < n
    rs = jnp.minimum(r, n - 1)
    w = j * bw + jnp.arange(bw, dtype=jnp.int32)
    m2 = rm[:, None] & (w < mw)[None, :]
    # the block's two candidate chromosomes and each word's choice
    c_lo = (j * bw) // cw
    c_hi = jnp.minimum(c_lo + 1, n_chr - 1)
    hi = jnp.broadcast_to((w >= (c_lo + 1) * cw)[None, :], (BR, bw))
    gr = g * n + rs  # (gamete, child) row of the plan arrays

    def pick(ref, width, k):
        lo = plgpu.load(ref.at[(gr * n_chr + c_lo) * width + k])
        up = plgpu.load(ref.at[(gr * n_chr + c_hi) * width + k])
        return jnp.where(hi, up[:, None], lo[:, None])

    full = jnp.uint32(FULL)
    zero = jnp.uint32(0)
    mask = jnp.where((pick(st_ref, 1, 0) & 1) == 1, full, zero)
    wb = jnp.broadcast_to(w[None, :], (BR, bw))
    for k in range(K):
        x = pick(xo_ref, K, k)  # global locus column; pad = m never hits
        xw = x >> 5
        part = jnp.left_shift(full, (x & 31).astype(jnp.uint32))
        mask = mask ^ (
            jnp.where(wb > xw, full, zero) | jnp.where(wb == xw, part, zero)
        )
    flip = jnp.zeros((BR, bw), jnp.uint32)
    for k in range(Km):
        p = plgpu.load(mu_ref.at[gr * Km + k])[:, None]
        bit = jnp.left_shift(jnp.uint32(1), (p & 31).astype(jnp.uint32))
        flip = flip ^ jnp.where(wb == (p >> 5), bit, zero)
    par = plgpu.load(par_ref.at[gr])
    rows = jnp.broadcast_to((2 * par)[:, None], (BR, bw))
    a = plgpu.load(hap_ref.at[rows, wb], mask=m2, other=0)
    b = plgpu.load(hap_ref.at[rows + 1, wb], mask=m2, other=0)
    orow = jnp.broadcast_to((2 * r + g)[:, None], (BR, bw))
    plgpu.store(out_ref.at[orow, wb], a ^ (mask & (a ^ b)) ^ flip, mask=m2)


@functools.partial(jax.jit, static_argnames=("chr_len", "interpret"))
def meiose_packed_triton(hap, fathers, mothers, xo_p, st_p, xo_m, st_m,
                         mu=None, *, chr_len: int, interpret: bool = False):
    """(n, 2, mw) child planes, bit-equal to `make_reproduce`'s XLA path:
    hap (N, 2, mw) uint32 parent planes, fathers/mothers (n,) rows, xo_*
    (n, n_chr, K) global crossover columns (pad = m), st_* (n, n_chr)
    start chromatids, mu (n, 2, Km) mutation columns (pad = m) or None."""
    N, _, mw = hap.shape
    n, n_chr, K = xo_p.shape
    cw = chr_len // 32
    bw = min(BW_MAX, 1 << (cw.bit_length() - 1))  # power of two <= cw
    i32 = lambda x: x.astype(jnp.int32).reshape(-1)
    ins = [
        i32(jnp.stack([fathers, mothers])),
        i32(jnp.stack([xo_p, xo_m])),
        i32(jnp.stack([st_p, st_m])),
    ]
    Km = 0
    if mu is not None:
        Km = mu.shape[-1]
        ins.append(i32(jnp.moveaxis(mu, 1, 0)))
    ins.append(hap.reshape(2 * N, mw))
    out = pl.pallas_call(
        functools.partial(_kernel, n=n, mw=mw, cw=cw, n_chr=n_chr, K=K,
                          Km=Km, bw=bw),
        grid=(pl.cdiv(n, BR), pl.cdiv(mw, bw), 2),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(ins),
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((2 * n, mw), jnp.uint32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="meiose_packed",
    )(*ins)
    return out.reshape(n, 2, mw)
