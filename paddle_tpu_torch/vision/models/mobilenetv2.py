"""MobileNetV2 (counterpart of paddle_tpu/vision/models/mobilenetv2.py):
inverted residuals with depthwise 3x3 convolutions and ReLU6."""
import torch

from ... import nn

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Layer):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 device=None):
        super().__init__(device=device)
        pad = (kernel - 1) // 2
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=pad, groups=groups, bias_attr=False,
                              device=device)
        self.bn = nn.BatchNorm2D(out_c, device=device)
        self.relu = nn.ReLU6()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__(device=device)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, device=device))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden,
                       device=device),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, device=device),
            nn.BatchNorm2D(oup, device=device),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__(device=device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, device=device)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    device=device))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel=1, device=device))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2),
                nn.Linear(self.last_channel, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
