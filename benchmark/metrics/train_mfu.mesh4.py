"""train_mfu.mesh4 (%): train_mfu's reader, in a cell sharded over several
ranks: the operations the traced iterations need over the traced chunk's
time, as a share of all the chips' FP32 peak."""
from benchmark.harness.common import reader

read = reader("train_mfu")
