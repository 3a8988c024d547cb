from .unet import UNet, UNetConfig  # noqa: F401
