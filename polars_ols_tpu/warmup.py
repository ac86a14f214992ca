"""Pre-compile the standard program family for a workload shape.

The reference imports instantly because its solvers are ahead-of-time
compiled Rust (src/expressions.rs); here every distinct (family, bucketed
shape) pair costs an XLA compile on first use. warmup runs one query per
family at the workload's shapes, so the programs are compiled before the
first real query. With JAX's persistent compilation cache (on by default,
config.py), a later process at the same shapes loads them from the cache
instead of compiling.

Usage: call ``polars_ols_tpu.warmup(n_rows, n_features, n_groups=...)``
once at service start (or once per fleet) with the workload's real shapes
— programs are keyed on *bucketed* padded shapes (engine/groups.py shape
buckets), so the synthetic data here compiles the same executables the
real queries will reuse.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from .expr import col
from .frame import DataFrame
from .utils import device_sync

#: family name -> kwargs for the `least_squares` namespace entry point
_FAMILIES = {
    "ols": dict(),
    "ols_qr": dict(solve_method="qr"),
    "ols_svd": dict(solve_method="svd"),
    "ridge": dict(alpha=0.01),
    "wls": dict(),  # sample_weights attached below
    "elastic_net": dict(alpha=0.01, l1_ratio=0.5),
    "rls": dict(half_life=20.0),
    "rolling_ols": dict(window_size=64),
}

DEFAULT_FAMILIES = ("ols", "ridge", "wls", "elastic_net", "rls", "rolling_ols")


def warmup(
    n_rows: int,
    n_features: int,
    n_groups: Optional[int] = None,
    families: Sequence[str] = DEFAULT_FAMILIES,
    modes: Sequence[str] = ("predictions",),
    statistics: bool = False,
    seed: int = 0,
    verbose: bool = False,
) -> Dict[str, float]:
    """Compile and execute one query per (family, mode) at this shape.

    Returns {"family/mode": seconds} — first-call times, dominated by the
    compiles this call exists to absorb. Subsequent queries at the same
    bucketed shape reuse the compiled executables (in-process) and the
    persistent compilation cache (cross-process).

    ``n_groups=None`` warms the single-frame path; an integer warms the
    grouped ``.over()`` path at that group count.
    """
    unknown = set(families) - set(_FAMILIES)
    assert not unknown, f"unknown families {sorted(unknown)}; pick from {sorted(_FAMILIES)}"
    rng = np.random.default_rng(seed)
    data = {
        "y": rng.normal(size=n_rows),
        "w": rng.uniform(0.5, 1.5, size=n_rows),
        **{f"x{i}": rng.normal(size=n_rows) for i in range(n_features)},
    }
    if n_groups is not None:
        data["g"] = rng.integers(n_groups, size=n_rows).astype(float)
    df = DataFrame(data)
    feats = [col(f"x{i}") for i in range(n_features)]

    modes = list(modes) + (["statistics"] if statistics else [])
    timings: Dict[str, float] = {}
    for fam in families:
        kwargs = dict(_FAMILIES[fam])
        method = kwargs.pop("solve_method", None)
        entry = "ols" if fam in ("ols_qr", "ols_svd") else fam
        for mode in modes:
            if mode == "statistics" and fam in ("rls", "rolling_ols"):
                continue  # moving models have no statistics mode (reference parity)
            ns = col("y").least_squares
            fn = getattr(ns, entry)
            call_kwargs = dict(kwargs, mode=mode)
            if method is not None:
                call_kwargs["solve_method"] = method
            if entry == "wls":
                call_kwargs["sample_weights"] = col("w")
            expr = fn(*feats, **call_kwargs)
            if n_groups is not None:
                expr = expr.over("g")
            t0 = time.perf_counter()
            out = df.select(expr.alias("out"))
            device_sync(out["out"])
            timings[f"{fam}/{mode}"] = time.perf_counter() - t0
            if verbose:  # pragma: no cover
                print(f"warmup {fam}/{mode}: {timings[f'{fam}/{mode}']:.2f}s")
    return timings
