from smpl_nerf_tpu_torch.models.render_ray_net import RenderRayNet  # noqa: F401
from smpl_nerf_tpu_torch.models.warp_field_net import WarpFieldNet  # noqa: F401
