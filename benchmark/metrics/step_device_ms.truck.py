"""step_device_ms.truck (ms): step_device_ms.train's reader, in the
one-card truck cell: device-busy time per training iteration."""
from benchmark.harness.common import reader

read = reader("step_device_ms.train")
