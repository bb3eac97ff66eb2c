"""nccl_share.mesh4 (%): the share of the ranks' device-busy time spent in
NCCL's kernels (the gathers, reduce-scatters and all-reduces of the banded
step), over all ranks of a sharded cell."""


def read(t):
    if t.get("kind") != "train" or t["chips"] < 2 or not sum(t["busy_s"]):
        return None
    return 100.0 * sum(t["nccl_s"]) / sum(t["busy_s"])
