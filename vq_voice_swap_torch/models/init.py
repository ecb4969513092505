"""Fresh-model initialisation that mirrors flax's defaults, as the JAX
package initialises a new training run (``layers.py``, ``unet.py``,
``mfcc_encoder.py``, ``wavegrad.py``, ``classifier.py``, ``vq.py``,
``vq_vae.py`` there):

- convolution and dense kernels: lecun-normal, drawn as flax draws it
  from a normal truncated at +-2 standard deviations, scaled to a
  variance of 1 / fan_in; biases 0;
- GroupNorm and LayerNorm: weight 1, bias 0;
- label embeddings: normal with variance 1 / features (``nn.Embed``),
  but a WaveGrad FiLM's ``label_emb`` zero;
- the VQ codebook: standard normal (its usage counter starts at
  dead_rate when the model is built);
- each ResBlock's ``conv_out``, the MFCC encoder's and the WaveGrad
  predictor's ``out_conv`` and the classifier's ``head`` zero; each
  ResBlock's ``cond_proj`` and each FiLM's ``out_conv`` lecun-normal
  scaled by 0.1.

The draws come from one CPU generator, so a seed gives the same weights
on any device.
"""

import math

import torch
from torch import nn

from ..vq import Codebook
from .classifier import Classifier
from .layers import ResBlock
from .mfcc_encoder import ConvMFCCEncoder
from .wavegrad import FiLM, WaveGradPredictor

__all__ = ["init_like_flax", "lecun_normal_"]

# The standard deviation of a unit normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal for a torch conv [Cout, Cin, K] or linear
    [out, in] weight: fan_in is Cin * K or in."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``model`` in place (see the module
    docstring); ``generator`` is a CPU generator."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            lecun_normal_(w, generator)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(m.embedding_dim))
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Codebook):
            m.dictionary.copy_(torch.randn(m.dictionary.shape, generator=generator))
    for m in model.modules():
        if isinstance(m, ResBlock):
            m.conv_out.conv.weight.zero_()
            if m.cond_proj is not None:
                m.cond_proj.weight.mul_(0.1)
        elif isinstance(m, (ConvMFCCEncoder, WaveGradPredictor)):
            m.out_conv.conv.weight.zero_()
        elif isinstance(m, FiLM):
            m.out_conv.conv.weight.mul_(0.1)
            if m.num_labels is not None:
                m.label_emb.weight.zero_()
        elif isinstance(m, Classifier):
            m.head.weight.zero_()
