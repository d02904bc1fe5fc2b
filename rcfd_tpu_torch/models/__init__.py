from .fusionnet import FusionNetModel
from .radarnet import RadarNetModel
