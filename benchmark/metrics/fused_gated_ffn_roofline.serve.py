"""``fused_gated_ffn_roofline.serve``: The FFN kernel's share of its roofline in a serving slice."""

from benchmark import readers


def read(ctx):
    return readers.ffn_roofline_pct(ctx, "serve")
