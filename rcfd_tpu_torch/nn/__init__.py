from . import functional
from .layers import (BatchNorm2d, Conv2d, DecoderBlock, FullyConnected,
                     ResNetBlock, UpConv2d, init_parameters)
from .optimize import fold_batch_norm
from .perf import PerfConfig
