"""Model zoo: the DenseNet, ResNet, ResNeXt and MobileNetV2 encoders + the
Dense-ASPP/LPG decoder (PyTorch)."""

from bts_tpu_torch.models.bts import BTSModel, ENCODERS, create_model  # noqa: F401
from bts_tpu_torch.models.decoder import BTSDecoder  # noqa: F401
