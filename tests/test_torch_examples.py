"""fos_tpu_torch's examples on the CPU: the role of tests/test_examples.py.

Every ``fos_tpu_torch/examples/*.py`` runs ``main(device="cpu", ...)`` at
small arguments (their defaults are sized for the card), prints, and passes
its own oracle assert; ``lasso.main_dsl`` runs the modeling layer's
variant.  An example without a card and without ``device`` raises.
"""

import importlib
import os

import pytest
import torch

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fos_tpu_torch", "examples")

ALL_EXAMPLES = sorted(
    f[:-3] for f in os.listdir(EXAMPLES_DIR)
    if f.endswith(".py") and not f.startswith("_"))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are small and eager,
    and the suite runs several worker processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the CPU runs the eager route with many small torch operations per CG
# step: these sizes keep the file near half a minute
SMALL_ARGS = {
    "batched_scenario_lps": dict(B=2, m=6, n=10),
    "lasso": dict(m=20, n=40),
    "nnls": dict(m=12, n=8),
    "parametric_sweep": dict(steps=2, m=8, n=12),
    "portfolio": dict(n=20, k=3),
    "portfolio_modeling": dict(n=20, k=3, gammas=(1.0, 5.0)),
    "sparse_banded": dict(m=1024, half_band=40),
    "youla": dict(nq=4, nt=10),
}


def _load(name):
    return importlib.import_module(f"fos_tpu_torch.examples.{name}")


def test_examples_inventory():
    assert ALL_EXAMPLES == sorted(
        f[:-3] for f in os.listdir(os.path.join(os.path.dirname(
            EXAMPLES_DIR), os.pardir, "examples"))
        if f.endswith(".py") and not f.startswith("_"))
    assert len(ALL_EXAMPLES) == 10


@pytest.mark.parametrize("name", ALL_EXAMPLES)
def test_example_runs(name, capsys):
    mod = _load(name)
    mod.main(device="cpu", **SMALL_ARGS.get(name, {}))
    assert capsys.readouterr().out.strip()


def test_lasso_dsl_variant(capsys):
    _load("lasso").main_dsl(device="cpu", **SMALL_ARGS["lasso"])
    assert capsys.readouterr().out.strip()


def test_examples_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load("sdp_min_eigenvalue").main()
