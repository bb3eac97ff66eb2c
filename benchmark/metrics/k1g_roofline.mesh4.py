"""k1g_roofline.mesh4 (%): k1g_roofline.train's reader, in a cell sharded
over several ranks: the frame's counted K1g work on one chip over the time
every rank's band launches took, summed."""
from benchmark.harness.common import reader

read = reader("k1g_roofline.train")
