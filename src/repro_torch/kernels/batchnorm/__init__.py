"""BatchNorm with batch statistics and its activation, NHWC, forward and
backward: hand-written CUDA kernels on the card, the plain formula on the
CPU."""

from repro_torch.kernels.batchnorm.ops import batchnorm_act, batchnorm_calls
from repro_torch.kernels.batchnorm.ref import batchnorm_act_ref

__all__ = ["batchnorm_act", "batchnorm_calls", "batchnorm_act_ref"]
