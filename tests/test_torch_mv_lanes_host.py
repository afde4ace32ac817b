"""Host-side pieces of K4/K5's lane kernels (no card needed): the order in
which K5's lane kernel deals out a blocked-ELL table's row blocks
(``sparse_ell.lane_task_order``), and the lines of the kernel sources
that the lane A/B tool's ablations edit (``tools/tile_lanes_ab.py``)."""

import numpy as np
import pytest
import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.linalg import sparse_ell as tse
from fos_tpu_torch.tools import tile_lanes_ab as ab

COUNTS = {
    "ragged_with_ties_and_empty": [3, 0, 5, 3, 1, 5, 0, 2],
    "uniform": [4] * 6,
    "one_row_block": [7],
    "random_256": np.random.default_rng(3).integers(0, 12, 256).tolist(),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_lane_task_order_longest_first(name):
    counts = torch.tensor(COUNTS[name], dtype=torch.int32)
    order = tse.lane_task_order(counts)
    assert order.dtype == torch.int32 and order.device == counts.device
    assert sorted(order.tolist()) == list(range(len(counts)))
    got = counts[order.long()].tolist()
    assert got == sorted(counts.tolist(), reverse=True)
    # ties keep the row order
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        if counts[a] == counts[b]:
            assert a < b


EDITS = [(product, name, edits)
         for product, table in (("pair", ab.ABLATIONS),
                                ("mv", ab.MV_ABLATIONS))
         for name, edits in table.items()]


@pytest.mark.parametrize("product,name,edits", EDITS,
                         ids=[f"{p}-{n}" for p, n, _ in EDITS])
def test_ablation_lines_stand_once(product, name, edits):
    """Each line an ablation replaces stands exactly once in this
    checkout's source, or the tool would skip that ablation on the
    card."""
    for fname, line, instead in edits:
        assert fname == ab.SOURCES[product]
        text = (_cuda.SRC_DIR / fname).read_text()
        assert text.count(line) == 1, (name, line)
        assert line != instead
