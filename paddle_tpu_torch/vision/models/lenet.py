"""LeNet of the PyTorch port.

Counterpart of ``paddle_tpu/vision/models/lenet.py``, with the reference's
layers and names (``features.0`` .. ``features.5``, ``fc.0`` .. ``fc.2``),
so a reference ``state_dict()`` loads with ``nn.load_numpy_state_dict``.
Made in f32 on ``device`` (``cuda`` unless ``"cpu"`` is asked for) from
``generator`` (the default generator when None).
"""
from __future__ import annotations


from ... import nn as pnn
from ...ops.manipulation import flatten


class LeNet(pnn.Layer):
    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = pnn.Sequential(
                pnn.Linear(400, 120, **kw),
                pnn.Linear(120, 84, **kw),
                pnn.Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
