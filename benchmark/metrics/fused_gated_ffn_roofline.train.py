"""``fused_gated_ffn_roofline.train``: The FFN kernel's share of its roofline in a training slice."""

from benchmark import readers


def read(ctx):
    return readers.ffn_roofline_pct(ctx, "train")
