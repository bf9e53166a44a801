"""The device's idle share of a traced selfplay call: 1 - busy / window,
in %, where busy is the union of the device operations' intervals inside
the call and its wait for the device (the arithmetic of
``alphatpu_torch.profile_generation.window``)."""


def read(ctx):
    p = ctx.get("profile")
    if ctx.get("kind") != "selfplay" or p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
