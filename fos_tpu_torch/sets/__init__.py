from fos_tpu_torch.sets.sets import (  # noqa: F401
    AffineSet,
    Ball,
    BlockSet,
    Box,
    ConeSet,
    FunctionSet,
    Halfspace,
    NonNeg,
    NonPos,
    Point,
)
