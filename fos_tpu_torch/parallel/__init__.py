"""Batched solves: many instances of one shape at once."""

from fos_tpu_torch.parallel.batched import (  # noqa: F401
    build_batched_form, form_initial_value, solve_batched)
