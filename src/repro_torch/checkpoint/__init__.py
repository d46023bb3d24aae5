"""Tree checkpoints in the reference's on-disk format."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step, latest_steps, restore_checkpoint, save_checkpoint)
