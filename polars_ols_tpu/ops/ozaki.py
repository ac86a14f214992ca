"""Exact f64-grade grouped moments via int8 digit matmuls (Ozaki scheme).

This module reformulates the moment matmuls (XtX/Xty) as the Ozaki splitting used
for exact GEMM on integer tensor cores (Ozaki et al., "Error-free
transformations of matrix multiplication", Numer. Algorithms 2012; the
int8 variant popularized for DGEMM emulation on low-precision matrix
units): each f64 value is decomposed into
radix-128 int8 digits with a per-(block, column) power-of-two scale,

    v = m * sum_i d_i * 128^-(i+1),   d_i in [-64, 64], m = 2^(e+1),

so every digit-pair product is exact in int8->int32 matmul arithmetic with
exact int32 accumulation (|d|<=64 -> products <=4096, x512 rows << 2^31).

Layout trick: the D digit planes are stored CONCATENATED along the column
axis, Zcat [S, R, D*C] int8, so ALL digit-pair products come from ONE
batched int8 matmul Zcat^T Zcat [S, D*C, D*C] whose [C, C] sub-blocks
are the pair products P_ij. The f64
recombination sums the sub-blocks with power-of-two level scales,
truncating pairs with i + j > PAIR_SUM (~58 significant bits kept —
9.7e-14 max relative error vs the f64 einsum, within the engine's fp64
parity gate).

Used when inputs are fully valid (NaN/null-free) and CONFIG.use_ozaki is
on; the f64 einsum path remains for null-policy masking (NaN propagation
semantics), for the CPU, and as the universal fallback. The scheme was
written for hardware without f64 units. On one H100, which has them, XLA
compiles the int8 matmul to a Triton GEMM, and the headline grouped OLS
(8M x 5 x 10k) still ran faster with it than with the f64 einsum, so
CONFIG.use_ozaki defaults on for the GPU (PERF.md, Findings).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

F64 = jnp.float64

RADIX = 128.0
N_DIGITS = 8  # digits 0..7
PAIR_SUM = 7  # keep digit pairs with i + j <= PAIR_SUM (~58 bits)

# Bound on the block row count: digit-pair products are <= 64^2 and must
# accumulate exactly. int32 accumulation holds to 2^31/4096 = 2^19 rows; the
# bound of 512 also keeps every block's sum (<= 2^21) exact in f32, so a
# GEMM that accumulates in f32 stays exact too. Enforced here independently
# of CONFIG.moment_chunk_rows.
MAX_BLOCK_ROWS = 512


@jax.jit
def decompose_blocks(
    Zp: jnp.ndarray,  # [S, R, C] f64 block values (padding rows arbitrary)
    wp: jnp.ndarray,  # [S, R] bool validity incl. padding
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split blocks into concatenated int8 digit planes.

    Returns (Zcat [S, R, D*C] int8 — digit d of column c at slot d*C + c,
    m [S, C] f64 per-block-column power-of-two scale). Invalid rows are
    zeroed so they vanish from every digit product."""
    assert Zp.shape[1] <= MAX_BLOCK_ROWS, (
        f"digit-moment blocks must have <= {MAX_BLOCK_ROWS} rows for exact "
        f"recombination (got {Zp.shape[1]}); lower POLS_TPU_CHUNK_ROWS"
    )
    Zm = Zp * wp[..., None]
    a = jnp.abs(Zm).max(axis=1)  # [S, C]
    e = jnp.ceil(jnp.log2(jnp.where(a > 0, a, 1.0)))
    m = jnp.exp2(e + 1.0)
    u = Zm / m[:, None, :]  # in [-0.5, 0.5]
    digits = []
    r = u
    for _ in range(N_DIGITS):
        d = jnp.round(r * RADIX)
        digits.append(d.astype(jnp.int8))
        r = r * RADIX - d
    return jnp.concatenate(digits, axis=-1), m


def recombine_pair_products(P: jnp.ndarray, C: int) -> jnp.ndarray:
    """f64 recombination of the [.., D*C, D*C] digit-pair product matrix:
    sum_{i+j<=PAIR_SUM} 128^-(i+j+2) * P[.., iC:(i+1)C, jC:(j+1)C]."""
    acc = None
    for s in range(PAIR_SUM + 1):
        level = None
        for i in range(0, s // 2 + 1):
            j = s - i
            p = P[..., i * C : (i + 1) * C, j * C : (j + 1) * C]
            q = p if i == j else p + jnp.swapaxes(p, -1, -2)  # P_ji = P_ij^T
            level = q if level is None else level + q
        term = level.astype(F64) * (RADIX ** -(s + 2))
        acc = term if acc is None else acc + term
    return acc


@partial(jax.jit, static_argnames=("num_groups",))
def moments_from_digits(
    Zcat: jnp.ndarray,  # [S, R, D*C] int8 concatenated digit planes
    m: jnp.ndarray,  # [S, C] f64 scales
    wp: jnp.ndarray,  # [S, R] bool (for the valid-row counts only)
    block_group: jnp.ndarray,  # [S]
    num_groups: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-group full moment matrix from one batched int8 matmul.

    Returns (M [G, C, C] f64 with M = Z^T diag(w) Z per group, counts [G]).
    The engine slices XtX / Xty out of M (target in column 0).
    """
    C = m.shape[-1]
    P = jax.lax.dot_general(
        Zcat,
        Zcat,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # [S, D*C, D*C]
    M = recombine_pair_products(P, C) * (m[:, :, None] * m[:, None, :])
    Mg = jax.ops.segment_sum(M, block_group, num_segments=num_groups)
    counts = jax.ops.segment_sum(
        wp.sum(axis=1).astype(F64), block_group, num_segments=num_groups
    )
    return Mg, counts
