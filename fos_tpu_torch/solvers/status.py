"""Status codes.

Device-friendly int32 codes for the reference's status symbols
(:Continue/:Optimal/:Unbounded/:Infeasible, HSDEStatus.jl:53-64, with
:Continue -> :Indeterminate at populate time, HSDE.jl:56-59).
"""

from __future__ import annotations


class Status:
    CONTINUE = 0
    OPTIMAL = 1
    UNBOUNDED = 2
    INFEASIBLE = 3
    INDETERMINATE = 4

    _NAMES = {
        CONTINUE: "Continue",
        OPTIMAL: "Optimal",
        UNBOUNDED: "Unbounded",
        INFEASIBLE: "Infeasible",
        INDETERMINATE: "Indeterminate",
    }

    @classmethod
    def name(cls, code) -> str:
        return cls._NAMES[int(code)]
