"""Training: schedules, the clip + Adam optimizer, the train/eval steps and
the Trainer loop."""
