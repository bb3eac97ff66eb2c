"""k3_roofline.full (%): k3_roofline.train's reader, in the 2024 recipe's
cell, where K3 also carries the inverse depth's cotangent: the counted
work of the recipe's frames (their antialiased opacities;
``harness/train_full.py::frame_work``) over K3's time."""
from benchmark.harness.common import reader

read = reader("k3_roofline.train")
