"""device_idle.truck (%): device_idle.train's reader, in the one-card
truck cell: the idle share of the traced training chunk."""
from benchmark.harness.common import reader

read = reader("device_idle.train")
