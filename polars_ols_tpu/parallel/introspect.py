"""Measured communication volume of compiled distributed programs.

`collective_bytes` sums the result bytes of every collective op in a
compiled HLO module — a measured number per executed program, used by
benchmarks/scaling.py for the scaling-efficiency evidence and by
`__graft_entry__.dryrun_multichip` to attach per-phase collective volumes
to the multi-chip artifact (the >=80% 1->N scaling expectation rests on
compute >> communication; these counts put numbers behind it).
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {"f64": 8, "f32": 4, "s64": 8, "s32": 4, "u32": 4, "bf16": 2,
                "f16": 2, "s8": 1, "u8": 1, "pred": 1}
_SHAPE_RE = re.compile(r"\b(f64|f32|s64|s32|u32|bf16|f16|s8|u8|pred)\[([0-9,]*)\]")
# Three forms are counted once each: sync ops (the CPU backend) by the bare
# op name; async pairs (all-reduce-start/-done, ...) by the -done half, whose
# result is the final tensor (the -start result is a tuple that would
# double-count); collectives wrapped in generic async-start/async-done (as
# XLA's GPU backend emits reduce-scatter and all-to-all) by the op inside
# the wrapped computation, which the bare name matches.
_COLL_RE = re.compile(
    r"\b(all-reduce|reduce-scatter|all-gather|collective-permute|all-to-all)"
    r"(-done)?\("
)


def collective_bytes(hlo_text: str) -> int:
    """Sum the result bytes of every collective op in compiled HLO text."""
    total = 0
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        head = line.split("=", 1)[0] if "=" in line else ""
        seg = line[len(head): m.start()]
        for sm in _SHAPE_RE.finditer(seg):
            dims = [int(d) for d in sm.group(2).split(",") if d]
            n = 1
            for d in dims:
                n *= d
            total += n * _DTYPE_BYTES[sm.group(1)]
    return total


# wrappers in sharded.py record their latest (jitted program, args, statics)
# here so callers can lower + compile the exact program they just ran and
# attach its measured collective bytes to reports
LAST_PROGRAMS: dict = {}


def record_program(name: str, jitted, args: tuple, kwargs: dict) -> None:
    LAST_PROGRAMS[name] = (jitted, args, kwargs)


def last_program_collective_bytes(name: str) -> int:
    """Collective bytes of the most recent program recorded under `name`."""
    jitted, args, kwargs = LAST_PROGRAMS[name]
    return collective_bytes(jitted.lower(*args, **kwargs).compile().as_text())
