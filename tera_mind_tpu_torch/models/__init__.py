from .unet import TeraUNet, TeraUNetConfig

__all__ = ["TeraUNet", "TeraUNetConfig"]
