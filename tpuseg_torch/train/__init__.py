"""Losses, metrics, the train and eval steps, and the Trainer."""
