"""Of the kernel time the slice's decode chunks launched, the share
launched inside the MoE route (``model.moe.route``: router product, f32
softmax, stable sort, one-hot, running count), in %."""
from harness import spans


def read(r):
    return spans.share_in_decode(r, ("model.moe.route",))
