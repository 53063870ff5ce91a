"""Of the kernel time the slice's decode chunks launched, the share
launched inside the expert products (``model.moe.experts``: the three
expert einsums and the SiLU over every expert's buffer), in %."""
from harness import spans


def read(r):
    return spans.share_in_decode(r, ("model.moe.experts",))
