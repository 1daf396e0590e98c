from mygauhuman_torch.pbr.light import (  # noqa: F401
    CubemapLight,
    build_mips,
    export_envmap,
    get_mip,
    init_cubemap_light,
)
from mygauhuman_torch.pbr.shade import (  # noqa: F401
    aces_film,
    get_brdf_lut,
    linear_to_srgb,
    pbr_shading,
)
