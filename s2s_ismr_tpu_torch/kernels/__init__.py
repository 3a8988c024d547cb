"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in `s2s_ismr_tpu_torch/csrc/`; they are compiled on
first use (kernels/_build.py), never at import."""

from .conv import (Conv3x3BiasAct, conv3x3_bias_act,  # noqa: F401
                   conv3x3_bias_act_plain)
