from .manager import (CheckpointCorrupt, CheckpointManager,
                      CheckpointWriteError, config_hash)

__all__ = ["CheckpointManager", "CheckpointCorrupt", "CheckpointWriteError",
           "config_hash"]
