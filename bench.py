"""Headline benchmark: grouped-OLS throughput on one GPU.

Runs the engine's north-star workload (BASELINE.json): grouped ordinary
least squares fit + predict over many groups, end-to-end through the
expression API (host layout + device solve), on the first GPU JAX finds.
Without a GPU it exits non-zero; there is no CPU fallback.

Baseline: the reference polars_ols sustains ~10.3M rows/s/core on its
n=2,000 x k=5 OLS-QR benchmark (BASELINE.md, README.md:217). We use the
same K=5 shape scaled to 8M rows across 10k groups — the reference would
dispatch 10k rayon plugin calls for this; the engine runs one batched
program.

Two numbers are measured and reported in ONE JSON line:

* ``materialized`` (the headline ``value``): every query's output column is
  fully materialized in row order on device (includes the [N]-element
  permutation out of the engine's group-block layout, fused into the query
  program).
* ``lazy``: the engine's default columnar output — block-ordered values
  with a deferred row-order permutation (series.BlockPermuted) that
  reductions/joins/slices never need to pay.

Protocol: batches of back-to-back queries, one ``block_until_ready`` on
the last query of each batch (the device runs programs in order); the
minimum and the median over 7 batches are reported. The line names the
device and the card's power limit.
"""

from __future__ import annotations

import json
import time

import numpy as np

from chip_smoke import block, card_line, make_frame, require_gpu

N_ROWS = 8_000_000
N_FEATURES = 5
N_GROUPS = 10_000
REFERENCE_ROWS_PER_S = 10.3e6  # polars_ols OLS-QR @ k=5 (BASELINE.md)
BATCH = 4
REPS = 7


def _measure(df, expr):
    def run():
        return df.select(expr)["y"]

    block(run())  # compile + warm layout caches
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        outs = [run() for _ in range(BATCH)]
        block(outs[-1])
        times.append((time.perf_counter() - t0) / BATCH)
    return float(np.min(times)), float(np.median(times))


def main() -> None:
    card = card_line()
    devs = require_gpu()
    import polars_ols_tpu as pot
    from polars_ols_tpu import CONFIG

    df, *_ = make_frame(N_ROWS, N_FEATURES, N_GROUPS, seed=0)
    features = [pot.col(f"x{i + 1}") for i in range(N_FEATURES)]
    expr = pot.col("y").least_squares.ols(*features).over("group")

    CONFIG.lazy_row_order = False
    mat_min, mat_med = _measure(df, expr)
    CONFIG.lazy_row_order = True
    lazy_min, lazy_med = _measure(df, expr)

    mat_rps = N_ROWS / mat_min
    lazy_rps = N_ROWS / lazy_min
    print(
        json.dumps(
            {
                "metric": "grouped_ols_rows_per_s_materialized",
                "value": round(mat_rps),
                "unit": "rows/s",
                "vs_baseline": round(mat_rps / REFERENCE_ROWS_PER_S, 3),
                "lazy_rows_per_s": round(lazy_rps),
                "lazy_vs_baseline": round(lazy_rps / REFERENCE_ROWS_PER_S, 3),
                "materialized_ms_median": mat_med * 1e3,
                "lazy_ms_median": lazy_med * 1e3,
                "card": card,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
