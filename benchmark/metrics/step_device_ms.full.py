"""step_device_ms.full (ms): step_device_ms.train's reader, in the 2024
recipe's cell: device-busy time per training iteration."""
from benchmark.harness.common import reader

read = reader("step_device_ms.train")
