"""Hand-written GPU kernels (with their plain PyTorch versions) and the
MFCC frontend."""
