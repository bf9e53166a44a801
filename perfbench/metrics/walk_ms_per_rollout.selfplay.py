"""Device milliseconds of the tree walk a rollout in a traced selfplay
call: the time of the walk kernels, found by name whatever the engine
level (``select_apply_packed``, ``select_apply_packed1``,
``select_apply``, ``select``), over the call's rounds x rollouts."""
import re

WALK = re.compile(r"(?<![A-Za-z0-9_])(select_apply_packed1|select_apply_packed"
                  r"|select_apply|select)_kernel(?![A-Za-z0-9_])")


def read(ctx):
    p = ctx.get("profile")
    if ctx.get("kind") != "selfplay" or p is None:
        return None
    walks = [(b - a) for name, a, b in p.ops if WALK.search(name)]
    if not walks:
        return None
    return sum(walks) / 1e3 / ctx["rollouts"]
