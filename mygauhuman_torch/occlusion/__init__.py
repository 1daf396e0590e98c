from mygauhuman_torch.occlusion.volumes import (  # noqa: F401
    IrradianceVolumes,
    recon_occlusion,
    sh_components,
)
from mygauhuman_torch.occlusion.baking import (  # noqa: F401
    bake_occlusion,
    bake_occlusion_full,
)
