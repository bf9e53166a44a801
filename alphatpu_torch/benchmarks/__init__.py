"""The port's measuring programs beside the bench: the config matrix
(:mod:`.matrix`), the rollout ablation (:mod:`.ablate_rollout`) and the
tictactoe loss replay (:mod:`.ttt_loss_replay`)."""
