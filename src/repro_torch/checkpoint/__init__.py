"""Atomic, async checkpoints of the port's trees of tensors
(``manager.CheckpointManager``)."""
