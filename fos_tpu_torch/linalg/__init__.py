from fos_tpu_torch.linalg.cg import CGResult, CGState, conjugate_gradient  # noqa: F401
from fos_tpu_torch.linalg import hsde_ops  # noqa: F401
from fos_tpu_torch.linalg.affine import HSDEAffineProjector  # noqa: F401
from fos_tpu_torch.linalg.compensated import cdot, cnorm  # noqa: F401
from fos_tpu_torch.linalg.dense_pair import PaddedDenseOp, fused_matvec  # noqa: F401
from fos_tpu_torch.linalg.sparse_ell import BandedBlockOp, BlockedEllOp  # noqa: F401
