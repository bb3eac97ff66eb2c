"""device_idle.full (%): device_idle.train's reader, in the 2024 recipe's
cell: the idle share of the traced training chunk."""
from benchmark.harness.common import reader

read = reader("device_idle.train")
