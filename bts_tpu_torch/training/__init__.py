"""Training: silog loss, poly LR, AdamW with set_misc freezing, the train
step, checkpoints, preemption, the run snapshot and the loop."""
