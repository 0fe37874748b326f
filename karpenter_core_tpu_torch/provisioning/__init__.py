from .provisioner import Provisioner, LaunchOptions
from .batcher import Batcher
