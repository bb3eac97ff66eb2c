"""raster_ms.mesh4 (ms): raster_ms.train's reader, in a cell sharded over
several ranks: rank 0's band binning, K1g, K3 and K4, with the binning of
the gathered packets every rank repeats."""
from benchmark.harness.common import reader

read = reader("raster_ms.train")
