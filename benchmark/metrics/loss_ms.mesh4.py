"""loss_ms.mesh4 (ms): loss_ms.train's reader, in a cell sharded over
several ranks: the frame-sized L1 + SSIM and backward every rank repeats,
on rank 0."""
from benchmark.harness.common import reader

read = reader("loss_ms.train")
