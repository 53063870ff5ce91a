"""Of the kernel time the slice's decode chunks launched, the share
launched inside the paged KV pool's copies (``serve.kv_gather``: every
live row's KV gathered dense; ``serve.kv_scatter``: the chunk's new
columns back to their pages), in %."""
from harness import spans


def read(r):
    return spans.share_in_decode(r, ("serve.kv_gather", "serve.kv_scatter"))
