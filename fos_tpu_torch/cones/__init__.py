from fos_tpu_torch.cones.spec import (  # noqa: F401
    Cone,
    ConeSpec,
    dual_cone,
    exp_dual,
    exp_primal,
    free,
    nonneg,
    nonpos,
    pow_dual,
    pow_primal,
    psd,
    rotated_soc,
    soc,
    zero,
)
from fos_tpu_torch.cones.project import (  # noqa: F401
    make_projector,
    project,
    project_dual,
    smat,
    svec,
)
