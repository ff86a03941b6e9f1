from .store import (AsyncCheckpointer, CheckpointCorrupt,
                    CheckpointWriteError, complete_steps, latest_step,
                    load_checkpoint, load_checkpoint_raw, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_raw",
           "latest_step", "complete_steps", "AsyncCheckpointer",
           "CheckpointCorrupt", "CheckpointWriteError"]
