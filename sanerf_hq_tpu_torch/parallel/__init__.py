from .mesh import (broadcast_params, data_sharding, init_process_group_from_env,
                   is_distributed, is_main_process, make_mesh, replicate,
                   shard_rays)
from .evaluate import make_sharded_eval_step, make_sharded_render
