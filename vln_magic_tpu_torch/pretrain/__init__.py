from .model import GlocalTextPathCMTPretrain
from .tasks import PathDataBuilder, mlm_mask
from .loader import MetaLoader
