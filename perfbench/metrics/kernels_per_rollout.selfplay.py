"""Device operations (kernels, copies, fills) a rollout in a traced
selfplay call: their number over the call's rounds x rollouts (the
arithmetic of ``alphatpu_torch.profile_generation.window``)."""


def read(ctx):
    p = ctx.get("profile")
    if ctx.get("kind") != "selfplay" or p is None or not p.ops:
        return None
    return len(p.ops) / ctx["rollouts"]
