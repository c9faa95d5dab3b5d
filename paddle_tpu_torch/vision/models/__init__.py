"""The vision model zoo (counterpart of paddle_tpu/vision/models): each
constructor takes device= (None: the current device)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,  # noqa: F401
                     resnet152, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
