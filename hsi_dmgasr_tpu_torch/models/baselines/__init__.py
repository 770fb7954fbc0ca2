"""The baseline HSI super-resolution zoo (PyTorch): a port of
``hsi_dmgasr_tpu/models/baselines``, each model NHWC in and out as in the
JAX package, its modules named so that the reference's state_dict keys
load as they are."""

from .cegatsr import CEGATSR
from .edsr import EDSR
from .gan3d import Discriminator as GAN3DDiscriminator
from .gan3d import Generator as GAN3DGenerator
from .gdrrn import GDRNN
from .gelin import GELIN
from .mcnet import MCNet
from .sspsr import SSPSR

__all__ = [
    "CEGATSR",
    "EDSR",
    "GAN3DDiscriminator",
    "GAN3DGenerator",
    "GDRNN",
    "GELIN",
    "MCNet",
    "SSPSR",
]
