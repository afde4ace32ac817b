"""History plotting: ``plothistory`` (the reference's src/debug.jl:1-8,
the primal-residual history on a log scale).  matplotlib is imported only
when no axis is given, so nothing else in the package needs it."""

from __future__ import annotations


def plothistory(history, key: str = "p", ax=None, **plot_kwargs):
    """Semilog plot of a history series (default: primal residual ``p``)."""
    if ax is None:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots()
    iters, vals = history.get(key)
    ax.semilogy(iters, vals, **plot_kwargs)
    ax.set_xlabel("iteration")
    ax.set_ylabel(key)
    ax.grid(True, which="both", alpha=0.3)
    return ax
