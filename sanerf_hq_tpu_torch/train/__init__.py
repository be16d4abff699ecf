from .checkpoints import CheckpointManager
from .metrics import psnr, ssim, Meter, MSEMeter, PSNRMeter, SSIMMeter
from .state import TrainState, mlp_field_lr_scales
from .steps import make_eval_render, make_rgb_train_step
from .trainer import Trainer
