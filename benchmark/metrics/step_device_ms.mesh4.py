"""step_device_ms.mesh4 (ms): step_device_ms.train's reader, in a cell
sharded over several ranks: device-busy time per iteration on a card, the
mean over the ranks."""
from benchmark.harness.common import reader

read = reader("step_device_ms.train")
