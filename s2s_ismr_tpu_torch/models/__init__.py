from .cnn import CNN  # noqa: F401
from .mlp import MLP  # noqa: F401
from .unet import UNet, UNetConfig  # noqa: F401
