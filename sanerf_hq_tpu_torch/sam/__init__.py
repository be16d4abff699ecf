"""SAM / HQ-SAM in PyTorch: the ViT image encoder, the prompt encoder, the
(HQ) mask decoder and the predictor, with the released checkpoints'
parameter names."""
from .build import Sam, build_sam, sam_model_registry
from .image_encoder import ImageEncoderViT
from .mask_decoder import MaskDecoder, MaskDecoderHQ
from .predictor import SamPredictor
from .prompt_encoder import PromptEncoder
