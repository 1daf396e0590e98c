from mygauhuman_torch.render.renderer import (  # noqa: F401
    CH,
    FrameInputs,
    RenderResult,
    render_frame,
)
