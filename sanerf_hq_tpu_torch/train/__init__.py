from .metrics import psnr, Meter, PSNRMeter
from .steps import make_eval_render
from .trainer import Trainer
