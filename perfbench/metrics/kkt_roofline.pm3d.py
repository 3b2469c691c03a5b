"""``kkt_roofline`` in the pm3d cell: the KKT kernel's share of its
roofline at the window's (41, 6, B) launches."""


def read(ctx):
    return ctx.metric("kkt_roofline")
