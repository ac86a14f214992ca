"""A/B of the backend-dependent CONFIG defaults on one GPU.

Each knob (``use_ozaki``, ``pair_gather``, ``moving_lanes``) is timed off
and on in turns A, B, B, A in one process, at the shape it serves:

* ``use_ozaki`` and ``pair_gather``: the headline grouped OLS, 8,000,000
  rows x 5 features x 10,000 groups, row order materialized;
* ``moving_lanes``: grouped 2,000,000 x 5 x 10,000 ``rls`` (half_life 252)
  and ``rolling_ols`` (window 252).

Every turn clears JAX's and the engine's caches (the knobs are read while
a program is traced), makes one call that compiles, then times
``--reps`` calls, each ended by ``block_until_ready``. It prints one JSON
line per knob and query: the medians of each turn, the median and
quartiles of all warm calls per setting, and the card's name and power
limit. The ``use_ozaki`` line also says which kernels XLA chose for the
int8 digit matmul.

Run: python benchmarks/defaults_ab.py [--reps 7] [--knobs use_ozaki,...]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import block, card_line, make_frame, require_gpu  # noqa: E402


def _turns(run, set_knob, reps: int):
    import jax

    import polars_ols_tpu as pls

    per_setting = {False: [], True: []}
    turns = []
    for value in (False, True, True, False):
        set_knob(value)
        jax.clear_caches()
        pls.clear_caches()
        t0 = time.perf_counter()
        block(run())
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            block(run())
            times.append(time.perf_counter() - t0)
        per_setting[value] += times
        turns.append({"on": value, "first_ms": first * 1e3,
                      "median_ms": float(np.median(times)) * 1e3})
    summary = {}
    for value, times in per_setting.items():
        q1, med, q3 = np.percentile(np.asarray(times) * 1e3, [25, 50, 75])
        summary["on" if value else "off"] = {
            "median_ms": med, "q1_ms": q1, "q3_ms": q3, "n": len(times)}
    return turns, summary


def _int8_dot_kernels() -> list:
    """Kernels in the compiled digit-moment program that read s8 operands."""
    import jax
    import jax.numpy as jnp

    from polars_ols_tpu.ops.ozaki import moments_from_digits

    S, R, C, G = 16_000, 512, 6, 10_000
    args = (jax.ShapeDtypeStruct((S, R, 8 * C), jnp.int8),
            jax.ShapeDtypeStruct((S, C), jnp.float64),
            jax.ShapeDtypeStruct((S, R), jnp.bool_),
            jax.ShapeDtypeStruct((S,), jnp.int32))
    hlo = moments_from_digits.lower(*args, num_groups=G).compile().as_text()
    found = []
    for line in hlo.splitlines():
        op = re.search(r"\b(custom-call|dot|fusion)\(", line)
        if op is None or "s8[" not in line:
            continue
        kind = (re.search(r'custom_call_target="([^"]+)"', line)
                or re.search(r'"kind":"([^"]+)"', line))
        name = op.group(1) + (":" + kind.group(1) if kind else "")
        if name not in found:
            found.append(name)
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--knobs", default="use_ozaki,pair_gather,moving_lanes")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = card_line()
    devs = require_gpu()

    from polars_ols_tpu import CONFIG, col

    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    knobs = args.knobs.split(",")
    feats = [col(f"x{i + 1}") for i in range(5)]
    ls = col("y").least_squares
    cells = []
    if {"use_ozaki", "pair_gather"} & set(knobs):
        df, *_ = make_frame(8_000_000, 5, 10_000, args.seed)
        headline = ls.ols(*feats).over("group")
        cells += [(k, "headline_materialized", df, headline)
                  for k in ("use_ozaki", "pair_gather") if k in knobs]
    if "moving_lanes" in knobs:
        df2, *_ = make_frame(2_000_000, 5, 10_000, args.seed)
        cells += [
            ("moving_lanes", "grouped_rls",
             df2, ls.rls(*feats, half_life=252.0).over("group")),
            ("moving_lanes", "grouped_rolling",
             df2, ls.rolling_ols(*feats, window_size=252).over("group")),
        ]
    CONFIG.lazy_row_order = False
    for knob, query, df, expr in cells:
        default = getattr(CONFIG, knob)

        def set_knob(v, knob=knob):
            setattr(CONFIG, knob, v)

        turns, summary = _turns(lambda: df.select(expr)["y"], set_knob, args.reps)
        set_knob(default)
        rec = {"knob": knob, "query": query, "turns": turns, **summary,
               "card": card, "device": device}
        if knob == "use_ozaki":
            rec["int8_dot_kernels"] = _int8_dot_kernels()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
