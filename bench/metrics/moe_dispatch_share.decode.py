"""Of the kernel time the slice's decode chunks launched, the share
launched inside the MoE data movement (``model.moe.dispatch``: the
expert buffers filled; ``model.moe.combine``: gathered back and summed
over the k choices), in %."""
from harness import spans


def read(r):
    return spans.share_in_decode(r, ("model.moe.dispatch",
                                     "model.moe.combine"))
