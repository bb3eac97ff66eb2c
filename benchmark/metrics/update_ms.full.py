"""update_ms.full (ms): update_ms.train's reader, in the 2024 recipe's
cell: the densification statistics and the sparse (column-masked) Adam a
training iteration; the exposures' Adam has its own stage there
(``exposure_depth_ms.full``)."""
from benchmark.harness.common import reader

read = reader("update_ms.train")
