"""Verbose status-table printing.

Replicates the reference's table layout byte-for-byte so golden-output tests
can assert on it (reference printers: HSDEStatus.jl:73-91,
FeasibilityStatus.jl:74-92; golden test: test/testprint.jl).  The ``cg``
column appears only for indirect (CG) solves.
"""

from __future__ import annotations


def hsde_header(init_duration_s: float, direct: bool) -> str:
    width = 76 + (0 if direct else 5)
    lines = [f"Time to initialize: {init_duration_s}s", "-" * width]
    row = " Iter | pri res | dua res | rel gap | pri obj | dua obj | kap/tau"
    if not direct:
        row += " | cg "
    row += " | time"
    lines.append(row)
    lines.append("-" * width)
    return "\n".join(lines)


def hsde_row(i, p, d, g, ctx, bty, kap_tau, t_s, cgiter=None) -> str:
    if cgiter is None:
        return "%6d|% 9.2e % 9.2e % 9.2e % 9.2e % 9.2e % 9.2e % .1es" % (
            i, p, d, g, ctx, -bty, kap_tau, t_s)
    return "%6d|% 9.2e % 9.2e % 9.2e % 9.2e % 9.2e % 9.2e % 4d % .1es" % (
        i, p, d, g, ctx, -bty, kap_tau, cgiter, t_s)


def feasibility_header(init_duration_s: float, direct: bool) -> str:
    width = 22 + (0 if direct else 5)
    lines = [f"Time to initialize: {init_duration_s}s", "-" * width]
    row = " Iter | res"
    if not direct:
        row += " | cg "
    row += " | time"
    lines.append(row)
    lines.append("-" * width)
    return "\n".join(lines)


def feasibility_row(i, err, t_s, cgiter=None) -> str:
    if cgiter is None:
        return "%6d|% 9.2e % .1es" % (i, err, t_s)
    return "%6d|% 9.2e % 4d % .1es" % (i, err, cgiter, t_s)


def found_solution(i) -> str:
    return f"Found solution i={i}"
