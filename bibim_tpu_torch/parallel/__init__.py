"""The band-sharded frame: horizontal bands of the framebuffer over the
devices of a mesh, in one process or one band per ``torch.distributed``
rank. Geometry is replicated and tiles are independent, so a frame needs
no exchange between bands; the image rows and the drop counts are
gathered at the end."""

from bibim_tpu_torch.parallel.mesh import (
    DeviceMesh,
    make_device_mesh,
    make_process_mesh,
)
from bibim_tpu_torch.parallel.tile_shard import (
    ShardedRenderer,
    render_frame_sharded,
)

__all__ = ["DeviceMesh", "ShardedRenderer", "make_device_mesh",
           "make_process_mesh", "render_frame_sharded"]
