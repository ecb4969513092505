from .mfcc_encoder import ConvMFCCEncoder
from .registry import make_encoder, make_predictor
from .unet import UNetEncoder, UNetPredictor
from .wavegrad import WaveGradEncoder, WaveGradPredictor

__all__ = [
    "ConvMFCCEncoder",
    "UNetEncoder",
    "UNetPredictor",
    "WaveGradEncoder",
    "WaveGradPredictor",
    "make_encoder",
    "make_predictor",
]
