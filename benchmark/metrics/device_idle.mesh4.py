"""device_idle.mesh4 (%): device_idle.train's reader, in a cell sharded over
several ranks: the idle share of the traced chunk, the mean over the ranks."""
from benchmark.harness.common import reader

read = reader("device_idle.train")
