from .checkpoints import CheckpointManager
from .metrics import (psnr, ssim, LPIPSMeter, Meter, MSEMeter, PSNRMeter,
                      SSIMMeter, pixel_accuracy)
from .state import TrainState, mlp_field_lr_scales
from .steps import make_eval_render, make_rgb_train_step
from .trainer import Trainer
