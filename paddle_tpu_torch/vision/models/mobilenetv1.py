"""MobileNetV1 (counterpart of paddle_tpu/vision/models/mobilenetv1.py):
depthwise 3x3 convolutions (groups = channels), each with BatchNorm and
ReLU, then a pointwise 1x1."""
import torch

from ... import nn

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 device=None):
        super().__init__(device=device)
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, device=device)
        self.bn = nn.BatchNorm2D(out_c, device=device)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale, device=None):
        super().__init__(device=device)
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride=stride, padding=1,
                              groups=in_c, device=device)
        self.pw = ConvBNLayer(c1, c2, 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__(device=device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1,
                                 device=device)
        cfg = [
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, a, b, st, scale, device=device)
            for (i, a, b, st) in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, device=device)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
