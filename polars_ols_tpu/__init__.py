"""polars_ols_tpu — a vectorized least-squares execution engine on JAX/XLA.

A from-scratch JAX/XLA framework with the capabilities of the reference
polars_ols polars-plugin (github.com/azmyrajab/polars_ols): a columnar
DataFrame/expression substrate, six null policies, a hash-partitioned
grouped engine, and batched device solvers for OLS/WLS/Ridge/Lasso/ElasticNet/
NNLS, recursive (Kalman) and rolling-window least squares, multi-target
regression, a formula API, out-of-sample prediction and model statistics.

Where the reference parallelizes per group on rayon threads and solves each
group with faer/LAPACK on a CPU core, this engine batches every group into
one XLA program (moments via batched matmuls, batched factorizations,
parallel prefix scans for the moving-window models) and shards the group axis
across device meshes (polars_ols_tpu.parallel).
"""

from __future__ import annotations

from .config import CONFIG
from .engine.groups import clear_caches
from .expr import Expr, col, lit, struct
from .frame import DataFrame, GroupBy, LazyFrame, concat
from .least_squares import (
    NullPolicy,
    OLSKwargs,
    OutputMode,
    RLSKwargs,
    RollingKwargs,
    SolveMethod,
    compute_least_squares,
    compute_least_squares_from_formula,
    compute_multi_target_least_squares,
    compute_recursive_least_squares,
    compute_rolling_least_squares,
    predict,
)
from .namespace import LeastSquares
from .series import ObjectSeries, Series, StructSeries
from .warmup import warmup

__version__ = "0.1.0"

__all__ = [
    "CONFIG",
    "clear_caches",
    "DataFrame",
    "Expr",
    "GroupBy",
    "LazyFrame",
    "LeastSquares",
    "ObjectSeries",
    "Series",
    "StructSeries",
    "col",
    "concat",
    "lit",
    "struct",
    "warmup",
    "compute_least_squares",
    "compute_least_squares_from_formula",
    "compute_multi_target_least_squares",
    "compute_recursive_least_squares",
    "compute_rolling_least_squares",
    "predict",
    "NullPolicy",
    "OLSKwargs",
    "OutputMode",
    "RLSKwargs",
    "RollingKwargs",
    "SolveMethod",
]
