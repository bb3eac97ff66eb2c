"""k3_roofline.mesh4 (%): k3_roofline.train's reader, in a cell sharded
over several ranks: the frame's counted K3 work on one chip over the time
every rank's band launches took, summed."""
from benchmark.harness.common import reader

read = reader("k3_roofline.train")
