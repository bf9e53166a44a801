"""The whole selfplay step's share of the card's peak, in %: the net's
operations (``peaks.net_flops_per_eval``, from its shapes) times the
evaluations the window's games needed (one a rollout of every lane),
over the window's seconds (taken outside the profiler) times the peak of
the type the tower's products ran in (``peaks.matmul_type``)."""


def read(ctx):
    if ctx.get("kind") != "selfplay" or not ctx.get("window_s"):
        return None
    return (100.0 * ctx["flops_per_eval"] * ctx["evaluations"]
            / (ctx["window_s"] * ctx["peak_flops"]))
