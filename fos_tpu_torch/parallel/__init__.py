"""Batched and sharded solves: many instances of one shape at once, and one
problem or batch split over the ranks of a ``torch.distributed`` mesh."""

from fos_tpu_torch.parallel.batched import (  # noqa: F401
    build_batched_form, form_initial_value, solve_batched)
from fos_tpu_torch.parallel.sharding import (  # noqa: F401
    RowShardedOp,
    make_hybrid_mesh,
    make_mesh,
    shard_batched_form,
    shard_batched_form_rows,
    shard_problem_2d,
    shard_problem_rows,
)
