"""The port's measuring programs beside the bench: the config matrix
(:mod:`.matrix`) and the rollout ablation (:mod:`.ablate_rollout`)."""
