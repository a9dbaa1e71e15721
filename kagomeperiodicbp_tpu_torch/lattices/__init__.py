from .directions import BlockSide, LatticeDir, signed_angle
from .kagome import KagomeBlock, num_message_sites
from . import triangle

__all__ = ["BlockSide", "LatticeDir", "signed_angle", "KagomeBlock", "num_message_sites", "triangle"]
