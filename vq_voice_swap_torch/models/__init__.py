from .mfcc_encoder import ConvMFCCEncoder
from .registry import make_encoder, make_predictor
from .unet import UNetEncoder, UNetPredictor

__all__ = [
    "ConvMFCCEncoder",
    "UNetEncoder",
    "UNetPredictor",
    "make_encoder",
    "make_predictor",
]
