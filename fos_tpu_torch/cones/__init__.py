from fos_tpu_torch.cones.spec import (  # noqa: F401
    Cone,
    ConeSpec,
    dual_cone,
    free,
    nonneg,
    nonpos,
    rotated_soc,
    soc,
    zero,
)
from fos_tpu_torch.cones.project import (  # noqa: F401
    make_projector,
    project,
    project_dual,
)
