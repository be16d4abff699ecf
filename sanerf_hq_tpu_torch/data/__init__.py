from .rays import (dirs_from_pixels, rays_from_pixels, full_frame_rays,
                   sample_random_pixels)
from .sampler import sample_rgb_batch
from .synthetic import (make_synthetic_dataset, look_at_pose, render_gt_sphere,
                        write_llff_scene)
