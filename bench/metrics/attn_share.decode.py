"""Of the kernel time the slice's decode chunks launched, the share
launched inside the attention core (``model.attn``: the KV cache write
through the attention product; the q/k/v/o projections are the GEMM
layer's), in %."""
from harness import spans


def read(r):
    return spans.share_in_decode(r, ("model.attn",))
