"""The JAX package's ten examples on fos_tpu_torch: each ``main(...,
device=None)`` runs on the card unless given ``device="cpu"``, prints what
it solved and asserts its own oracle.

    python3 -m fos_tpu_torch.examples.lasso
"""
