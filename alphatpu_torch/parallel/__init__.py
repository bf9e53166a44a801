"""Data-parallel training over ``torch.distributed``, the counterpart of
:mod:`alphatpu.parallel`.

Each rank is a process with a device of its own: it plays ``1/D`` of the
selfplay and duel games, holds ``1/D`` of the replay buffer and samples
its own batches; the learner averages the gradients over the ranks, so the
weights stay replicated.  :mod:`.mesh` holds the world and its
collectives, :mod:`.sharded` the executors (``sharded_selfplay_fn``,
``sharded_train_fn``, ``sharded_duel_fn``, ``sharded_duel_network``) and
:mod:`.dryrun` the multi-rank dry run.  The executors are not imported
here: the buffer and the learner import :mod:`.mesh`, and the executors
import them.
"""
from .mesh import (  # noqa: F401
    World,
    all_gather,
    all_reduce,
    make_world,
    psum_stats,
    rank_generator,
    run_ranks,
    world_rank,
    world_size,
)
